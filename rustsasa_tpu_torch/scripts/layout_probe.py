"""Layout choices of the list-occlusion kernel, and what the host's
enqueue adds to the short kernels' times, on the card.

    python -m rustsasa_tpu_torch.scripts.layout_probe [--enqueue]

Builds csrc/list_occlusion.cu as it is and with one layout choice changed
by a text substitution that must apply (CUTS), and times each build in
turns (as is, the others, then back) on 1jz8's neighbor records at 100
points (the smoke's phase 5): as it is (16 records a thread), with 8
records a thread (3 CTAs a SM), with 2 or 8 points a loop step, each at 1
and 2 blocks of points (label "<build>/<blocks>"); and, timed only
(TIMING_ONLY: their outputs are wrong), without the per-stage wait and
barrier (nobar) and without the loads after the first stage (noload).

Every other build computes the same outputs; the script checks that each
equals the plain version before timing it.

The enqueue probe (alone with --enqueue; it calls only the public
wrappers, so it runs on any tree of the port) times the list kernel at
1jz8 and the kernel experiments' nobig and noscalar at T = 512 x NJ =
1,408 three ways: as `_study.timed` does (each call between two events
on an idle card, so the host's enqueue of the call is inside), with the
stream first spinning SPIN_CYCLES so that the enqueue falls inside the
spin (the kernels' device time), and the host's time a call, calls
enqueued back to back.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from ..ops import _kernels, engine, neighbors
from . import _study
from . import kernel_experiments as ke

PROBE = 1.4
N_POINTS = 100
LIST_STRUCTURE = os.path.join(_study.TEST_STRUCTURES, "1jz8.pdb.gz")

# Kernel source -> [(tag, [(text, replacement), ...])]; the first build is
# the source as it is.
CUTS = {
    "list_occlusion": (
        ("recs16", []),
        ("recs8", [("constexpr int kRecs = 16;", "constexpr int kRecs = 8;"),
                   ("constexpr int kMinCtas = 2;",
                    "constexpr int kMinCtas = 3;")]),
        ("unroll2", [("constexpr int kPointUnroll = 4;",
                      "constexpr int kPointUnroll = 2;")]),
        ("unroll8", [("constexpr int kPointUnroll = 4;",
                      "constexpr int kPointUnroll = 8;")]),
        ("nobar", [("    asm volatile(\"cp.async.wait_group 0;\\n\" ::: "
                    "\"memory\");\n    // Stage st is visible, and every "
                    "thread is done with the buffer the\n    // next stage "
                    "overwrites.\n    __syncthreads();\n", "")]),
        ("noload", [("    if (st + 1 < n_stages) {\n      stage_rows(",
                     "    if (false) {\n      stage_rows(")]),
    ),
}
# Blocks of points the list kernel's builds are timed at (the plan's
# count for the sphere, and more, each CTA then adding its counts).
LIST_BLOCKS = (1, 2)
# Builds that only time a part: their outputs are wrong and not checked.
TIMING_ONLY = ("nobar", "noload")
# GPU clock cycles (~0.2 ms) the enqueue probe spins the stream before its
# start event: longer than the host takes to enqueue a call.
SPIN_CYCLES = 400_000


def list_records(device, path=LIST_STRUCTURE, n_points=N_POINTS):
    """The list path's inputs for one structure, as its neighbor phase
    makes them: {"planes": [vx, vy, vz, limit] [K, N] K-major, "area",
    "sphere", "kmax", "n" (atoms), "max_count", "neighbor_s" (host clock
    of the neighbor phase, first call), "copy_ms" (device time of the four
    K-major copies, CUDA events)}."""
    coords, radii, gids = _study.select(path)
    n = coords.shape[0]
    n_pad = neighbors._round_bucket(n, neighbors._N_BUCKETS)
    packed, g = (torch.from_numpy(a[0]).to(device)
                 for a in engine._pack(n_pad, [(coords, radii, gids)]))
    k = neighbors._initial_k(n_pad)
    t0 = time.perf_counter()
    while True:
        v, limit, counts, mc = neighbors._neighbor_phase(
            packed, g, probe=PROBE, k=k)
        if int(mc) <= k:
            break
        k = min(neighbors._round_bucket(int(mc), neighbors._K_BUCKETS), n_pad)
    if device.type == "cuda":
        torch.cuda.synchronize()
    neighbor_s = time.perf_counter() - t0

    def copies():
        # neighbors.occlusion_sasa's K-major copies of the records.
        return [t.T.contiguous() for t in (v[..., 0], v[..., 1], v[..., 2],
                                          limit)]

    copy_ms = _study.timed(copies, device, 20)[1] if device.type == "cuda" \
        else None
    return {
        "planes": copies(),
        "area": neighbors._area_factor(packed[:, 3], g >= 0, PROBE, n_points),
        "sphere": engine._sphere_device(n_points, device),
        "kmax": neighbors.tile_kmax(counts, limit.shape[1]),
        "n": n, "max_count": int(mc), "neighbor_s": neighbor_s,
        "copy_ms": copy_ms,
    }


def _time_builds(name, calls_for, check, device, reps):
    """{label: best warm ms} of the calls calls_for(tag, fn) gives
    ({label: call}) for each build of CUTS[name], each checked, then timed
    in turns (forward, then back)."""
    fns = _kernels.build_sources(
        "layout_probe", _kernels.cut_sources(name, CUTS[name]),
        f"{name}_launch", _kernels._SIGNATURES[name])
    calls = {}
    for tag, _ in CUTS[name]:
        calls.update(calls_for(tag, fns[tag]))
    for label, call in calls.items():
        if label.split("/")[0] not in TIMING_ONLY:
            check(label, call)
    ms = {}
    for label in list(calls) + list(calls)[::-1]:
        _first, best, _ = _study.timed(calls[label], device, reps)
        ms[label] = min(ms.get(label, best), best)
    return ms


def run(device, *, reps: int = 20) -> dict[str, float]:
    """{"<build>/<blocks>": best warm ms} of the list kernel's builds."""
    device = torch.device(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rec = list_records(device)
    lp = rec["planes"]
    n = lp[0].shape[1]
    k = lp[0].shape[0]
    p = rec["sphere"].shape[0]
    out = torch.empty(n, dtype=torch.float32, device=device)
    counts = torch.empty(n, dtype=torch.int32, device=device)
    want_list = neighbors.occlusion_sasa_reference(
        *lp, rec["area"], rec["sphere"], rec["kmax"])
    plan_blocks = _kernels.list_point_plan(p)[0]

    def listed(tag, fn):
        calls = {}
        for blocks in sorted({plan_blocks, *LIST_BLOCKS}):
            pb = -(-p // blocks)
            hp = -(-pb // 2)

            def call(blocks=blocks, pb=pb, hp=hp):
                rc = fn(*(t.data_ptr() for t in lp), rec["area"].data_ptr(),
                        rec["sphere"].data_ptr(), rec["kmax"].data_ptr(),
                        counts.data_ptr(), out.data_ptr(),
                        n, k, p, blocks, pb, hp, stream)
                if rc != 0:
                    raise RuntimeError(f"list_occlusion_launch: cudaError {rc}")
                return out
            calls[f"{tag}/{blocks}"] = call
        return calls

    def check_list(tag, call):
        out.fill_(float("nan"))
        got = call()
        torch.cuda.synchronize()
        if not torch.equal(got, want_list):
            raise AssertionError(f"list_occlusion {tag}: differs from its "
                                 "plain version")

    return _time_builds("list_occlusion", listed, check_list, device, reps)


def enqueue_probe(fn, device, reps):
    """(best ms as `_study.timed` reads it, best ms with the host's
    enqueue hidden behind a spin, host us a call enqueued back to back)
    of fn()."""
    timed_ms = _study.timed(fn, device, reps)[1]
    spun_ms = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        spun_ms = min(spun_ms, start.elapsed_time(stop))
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize(device)
    return timed_ms, spun_ms, host_us


def enqueue(device, *, reps: int = 50) -> dict[str, tuple[float, ...]]:
    """{kernel: enqueue_probe(...)} for the list kernel at 1jz8 and the
    kernel experiments' nobig and noscalar at the script's T x NJ."""
    device = torch.device(device)
    rec = list_records(device)
    sphere, planes, jd = ke.synthetic_inputs(ke.T, ke.NJ, device)
    calls = {
        "list_occlusion": lambda: _kernels.list_occlusion(
            *rec["planes"], rec["area"], rec["sphere"], rec["kmax"]),
        "nobig": lambda: ke.experiment("nobig", sphere, planes, jd),
        "noscalar": lambda: ke.experiment("noscalar", sphere, planes, jd),
    }
    return {name: enqueue_probe(fn, device, reps)
            for name, fn in calls.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("layout_probe: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    name = _study.device_name(device)
    if "--enqueue" not in argv:
        ms = run(device)
        print(f"layout_probe list_occlusion on {name}: "
              + ", ".join(f"{tag} {v:.4f} ms" for tag, v in ms.items()),
              flush=True)
    for kernel, (timed_ms, spun_ms, host_us) in enqueue(device).items():
        print(f"layout_probe enqueue {kernel} on {name}: timed "
              f"{timed_ms:.4f} ms, behind a spin {spun_ms:.4f} ms, host "
              f"{host_us:.1f} us a call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
