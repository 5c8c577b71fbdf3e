"""Is the corpus pass wire-bound or compute-bound?  The split, on the card.

Port of `scripts/r3_split.py`:

    python -m rustsasa_tpu_torch.scripts.r3_split [corpus_dir] \\
        [--device cuda|cpu]

The first 900 files of the corpus in name order (the port's bench
corpus, built under build/rustsasa_tpu_torch/bench/ when absent), loaded
at residue level with the port's native loader on 4 threads, go through
two routes, each timed as the reference times its one: every window
ends with a readback to the host, on the host clock.

  f32 : the reference's route, the host-cull f32 wire
        (`fused_kernel.pack_structures`, 20 B a slot and the host's
        j-lists), padded to M_PAD = 2,097,152 slots, through
        `fused_kernel.fused_sasa` (kernel 1, then the areas, read back
        as f32);
  q13 : the port's main path, the banded q13 wire the bench sends (6 B
        a slot, not padded: the engine takes any multiple of 128 slots)
        at the engine's band width, through the engine's own entry
        point, `fused_kernel.fused_sasa_q13_banded` (`dequant_boxes`,
        `band_jlist` and `fused_count`; its `mark` hook places the
        events between them).

For each: the first call (wire to the device, kernels, readback), three
warm end-to-end calls, the copy to the device alone, three calls of the
kernels alone on the wire already there (each kernel also between two
CUDA events on a card), and the readback alone.  The end-to-end outputs
are held byte-equal to the kernels-alone ones, and the q13 counts of
every structure to `BatchedSasaEngine`'s on the same structures.

Then one whole pass of the bench (`batch.process_directory` over the
whole corpus at residue level, JSON output) on a fresh engine, with
each chunk's device work (its dequant, cull, count kernel and the
readback's dtype cast, everything between the copies in and the copy
out) between two CUDA events: the pass's wall time, the device's busy
time (the sum over the chunks) and the idle share, 1 - busy / wall.
Every figure stands beside the card's name and power limit; the last
line is one JSON object of them.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import _kernels, engine, fused_kernel as fk
from . import _study

FILES = 900
M_PAD = 2_097_152
N_POINTS = 100
PROBE = 1.4
REPS = 3
LOAD_THREADS = 4
# The four wires' entry points, whose calls the pass's events bracket.
CHUNK_FUNCTIONS = ("fused_sasa_q13_banded", "fused_sasa_q16_banded",
                   "fused_sasa_q16", "fused_sasa")
# The figures of the reference's lines, each route's.
SPLIT_KEYS = ("wire_mb", "first_s", "e2e_ms", "h2d_ms", "kernels_ms",
              "d2h_ms", "out_mb")


def load_triples(corpus_dir=None, files: int = FILES) -> list:
    """(coords, radii, gids) of the first `files` corpus files in name
    order, selected at residue level on LOAD_THREADS threads."""
    paths = _study.corpus_files(corpus_dir)[:files]
    with ThreadPoolExecutor(max_workers=LOAD_THREADS) as pool:
        return list(pool.map(_study.select, paths))


def host_cull_wire(triples, slots: int = M_PAD):
    """pack_structures' f32 wire of `triples` zero-padded to `slots`
    slots: (planes5 [5, slots] f32, jlist [slots / 128, 128] u32), and
    the structures its j-lists overflowed."""
    planes, jlist, _offsets, failed = fk.pack_structures(triples, PROBE,
                                                         N_POINTS)
    m = planes.shape[1]
    if m > slots:
        raise ValueError(f"{m} slots packed, more than {slots}")
    return (np.pad(planes, ((0, 0), (0, slots - m))),
            np.pad(jlist, ((0, (slots - m) // fk.ATOM_TILE), (0, 0))),
            failed)


def q13_wire(triples):
    """The banded q13 wire of `triples` as the engine packs one chunk:
    ((wire_a, wire_b, palette, tparams, tmeta), offsets, w), w the
    engine's band width for the largest structure."""
    packed = fk.pack_structures_q13(triples, PROBE)
    if packed is None:
        raise ValueError("a structure cannot take the q13 wire")
    *wire, offsets = packed
    max_nt = max(-(-t[0].shape[0] // fk.ATOM_TILE) for t in triples)
    if max_nt > fk.W_BUCKETS[-1]:
        raise ValueError(f"a structure of {max_nt} tiles is past the band")
    return tuple(wire), offsets, next(b for b in fk.W_BUCKETS
                                      if b >= max_nt)


class Marks:
    """Stage times of work queued on `device`'s current stream: CUDA
    events on a card, the host clock on the CPU (whose plain versions run
    as they are called)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.names: list[str] = []
        self.points = [self._point()]

    def _point(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def mark(self, name: str) -> None:
        self.names.append(name)
        self.points.append(self._point())

    def ms(self) -> dict:
        """{stage: ms}; waits for the last mark on a card."""
        if self.cuda:
            self.points[-1].synchronize()
            return {n: a.elapsed_time(b) for n, a, b in
                    zip(self.names, self.points, self.points[1:])}
        return {n: (b - a) * 1e3 for n, a, b in
                zip(self.names, self.points, self.points[1:])}


def f32_kernels(planes5, jlist, sphere, *, marks: Marks):
    out = fk.fused_sasa(planes5, jlist, sphere, n_points=N_POINTS)
    marks.mark("fused_count")
    return out


def _readback(t: torch.Tensor) -> None:
    """A readback of 8 values: waits for everything queued before it on
    the current stream."""
    t.reshape(-1)[:8].cpu()


def split(wire, kernels, device, atoms: int, reps: int = REPS) -> dict:
    """The reference's split of one route: `wire` the host arrays,
    `kernels(*device_arrays, marks=)` the device work.  Returns the
    SPLIT_KEYS figures (ms on the host clock; e2e_ms and kernels_ms
    lists of `reps`), the kernels' marks a run (`stage_ms`), Matoms/s of
    each e2e and kernels run, whether every e2e output equals every
    kernels-alone one (`e2e_equals_kernels`), and the last output
    (`out`, numpy)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def e2e():
        d = fk.to_device(wire, device)
        return kernels(*d, marks=Marks(device)).cpu()

    sync()
    t0 = time.perf_counter()
    first = e2e()
    first_s = time.perf_counter() - t0
    e2e_ms, outs = [], [first]
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        outs.append(e2e())
        e2e_ms.append((time.perf_counter() - t0) * 1e3)

    sync()
    t0 = time.perf_counter()
    resident = fk.to_device(wire, device)
    _readback(resident[-1])
    h2d_ms = (time.perf_counter() - t0) * 1e3

    kernels_ms, stage_ms, kept = [], [], []
    for _ in range(reps):
        sync()
        marks = Marks(device)
        t0 = time.perf_counter()
        out = kernels(*resident, marks=marks)
        _readback(out)
        kernels_ms.append((time.perf_counter() - t0) * 1e3)
        stage_ms.append(marks.ms())
        kept.append(out)

    sync()
    t0 = time.perf_counter()
    full = out.cpu()
    d2h_ms = (time.perf_counter() - t0) * 1e3
    equal = all(torch.equal(a, outs[0]) for a in outs) and all(
        torch.equal(k.cpu(), outs[0]) for k in kept)
    return {
        "wire_mb": sum(a.nbytes for a in wire) / 1e6, "first_s": first_s,
        "e2e_ms": e2e_ms, "h2d_ms": h2d_ms, "kernels_ms": kernels_ms,
        "stage_ms": stage_ms, "d2h_ms": d2h_ms,
        "out_mb": full.numel() * full.element_size() / 1e6,
        "e2e_matoms_s": [atoms / ms / 1e3 for ms in e2e_ms],
        "kernels_matoms_s": [atoms / ms / 1e3 for ms in kernels_ms],
        "e2e_equals_kernels": bool(equal), "out": full.numpy(),
    }


@contextlib.contextmanager
def chunk_events(device):
    """Bracket every chunk's device work (the four wires' entry points)
    in CUDA events on the chunk's stream (host clock on the CPU) while
    the block runs; yields the list of the chunks' ms, complete once the
    block's work has been read back."""
    spans: list = []
    saved = {name: getattr(fk, name) for name in CHUNK_FUNCTIONS}

    def timed(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            dev = args[0].device
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                marks = Marks(dev)
                out = fn(*args, **kwargs)
                marks.mark("chunk")
            spans.append(marks)
            return out
        return wrapper

    for name, fn in saved.items():
        setattr(fk, name, timed(fn))
    ms: list = []
    try:
        yield ms
    finally:
        for name, fn in saved.items():
            setattr(fk, name, fn)
    ms.extend(m.ms()["chunk"] for m in spans)


def bench_pass(corpus_dir, device, out_dir) -> dict:
    """One pass of the bench over `corpus_dir` on a fresh engine with
    every chunk's device work timed: wall_s, busy_ms, idle_share, chunks,
    routes, launches of the main path's kernels, n_files, n_ok."""
    from ..api import SASAOptions
    from ..batch import process_directory
    from ..levels import Level

    eng = engine.BatchedSasaEngine(engine.SasaParams(), device=device)
    options = SASAOptions(level=Level.RESIDUE, device=device)
    launches0 = dict(_kernels.launch_counts)
    with chunk_events(device) as chunk_ms:
        t0 = time.perf_counter()
        report = process_directory(corpus_dir, out_dir, options, "json",
                                   progress=False, engine=eng)
        wall_s = time.perf_counter() - t0
    busy_ms = float(sum(chunk_ms))
    return {
        "wall_s": wall_s, "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (wall_s * 1e3),
        "chunks": len(chunk_ms), "routes": dict(eng.routes.counts),
        "launches": {k: _kernels.launch_counts[k] - launches0[k]
                     for k in ("dequant_boxes", "band_jlist", "fused_count")},
        "n_files": report.n_files, "n_ok": report.n_ok,
        "errors": len(report.errors),
    }


def engine_counts(triples, device) -> list[np.ndarray]:
    """Each structure's counts in its atom order, from
    BatchedSasaEngine's dispatch of `triples` (the counts CountsView
    holds for `compute`)."""
    eng = engine.BatchedSasaEngine(engine.SasaParams(), device=device)
    views = eng.enqueue(triples).collect_views()
    return [np.asarray(v.counts)[v.inv] for v in views]


def run(corpus_dir=None, device="cuda", *, files: int = FILES,
        slots: int = M_PAD, reps: int = REPS, out_dir=None) -> dict:
    """The split of both routes and the bench pass; returns {"files",
    "atoms", "load_s", "routes": {"f32": split(), "q13": split() plus
    "w", "slots", "equals_engine"}, "pass": bench_pass(), and cpu_count,
    gpu_name, power_limit}.  `out_dir`: where the pass writes (a
    temporary directory by default)."""
    dev = engine.resolve_devices(device)[0]
    src = _study.bench_corpus(corpus_dir)
    t0 = time.perf_counter()
    triples = load_triples(src, files)
    load_s = time.perf_counter() - t0
    atoms = sum(t[0].shape[0] for t in triples)
    sphere = engine._sphere_device(N_POINTS, dev)

    planes5, jlist, failed = host_cull_wire(triples, slots)
    f32 = split((planes5, jlist),
                lambda p, j, marks: f32_kernels(p, j, sphere, marks=marks),
                dev, atoms, reps)
    f32.update(slots=slots, failed=len(failed))

    wire, offsets, w = q13_wire(triples)
    q13 = split(wire, lambda *d, marks: fk.fused_sasa_q13_banded(
        *d, sphere, n_points=N_POINTS, w=w, mark=marks.mark),
        dev, atoms, reps)
    mine = [q13["out"][pos:pos + n][inv] for pos, n, inv in offsets]
    theirs = engine_counts(triples, dev)
    q13.update(w=w, slots=wire[0].shape[0], equals_engine=len(mine) == len(
        theirs) and all(np.array_equal(a, b) for a, b in zip(mine, theirs)))

    with (tempfile.TemporaryDirectory() if out_dir is None
          else contextlib.nullcontext(out_dir)) as out:
        bench = bench_pass(src, dev, out)
    return {"files": len(triples), "atoms": atoms, "load_s": load_s,
            "routes": {"f32": f32, "q13": q13}, "pass": bench,
            **_study.where(dev)}


def lines(r: dict) -> list[str]:
    """The reference's lines for each route, then the pass and where it
    ran."""
    out = [f"{r['files']} files, {r['atoms']} atoms, loaded in "
           f"{r['load_s']:.3f}s"]
    for name, s in r["routes"].items():
        e2e = ", ".join(f"{ms:.3f}ms ({a:.2f} Matoms/s)" for ms, a in
                        zip(s["e2e_ms"], s["e2e_matoms_s"]))
        kern = ", ".join(f"{ms:.3f}ms ({a:.2f} Matoms/s)" for ms, a in
                         zip(s["kernels_ms"], s["kernels_matoms_s"]))
        stages = "; ".join(", ".join(f"{k} {v:.4f}" for k, v in run.items())
                           for run in s["stage_ms"])
        out += [
            f"[{name}] M={s['slots']}"
            + (f", w={s['w']}" if "w" in s else "")
            + f": wire {s['wire_mb']:.3f} MB, first call+readback "
              f"{s['first_s']:.3f}s",
            f"[{name}] warm e2e (h2d + kernels + readback): {e2e}",
            f"[{name}] h2d only: {s['h2d_ms']:.3f}ms for "
            f"{s['wire_mb']:.3f} MB = {s['wire_mb'] / s['h2d_ms'] * 1e3:.1f}"
            " MB/s",
            f"[{name}] kernels only + tiny readback: {kern}",
            f"[{name}] kernels by event (ms): {stages}",
            f"[{name}] d2h readback: {s['d2h_ms']:.3f}ms for "
            f"{s['out_mb']:.3f} MB",
            f"[{name}] e2e output equals kernels-only: "
            f"{s['e2e_equals_kernels']}"
            + (f"; counts equal the engine's: {s['equals_engine']}"
               if "equals_engine" in s else ""),
        ]
    p = r["pass"]
    out.append(
        f"[pass] {p['n_ok']}/{p['n_files']} files in {p['wall_s']:.3f}s; "
        f"device busy {p['busy_ms']:.3f}ms over {p['chunks']} chunks; idle "
        f"share {p['idle_share']:.4f}; routes {p['routes']}; launches "
        f"{p['launches']}")
    out.append(_study.where_line(r))
    return out


def record(r: dict) -> dict:
    """run()'s result without the routes' outputs: its JSON line."""
    return {**r, "routes": {name: {k: v for k, v in s.items() if k != "out"}
                            for name, s in r["routes"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("corpus_dir", nargs="?", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    result = run(args.corpus_dir, args.device)
    for line in lines(result):
        print(line, flush=True)
    print(json.dumps(record(result)))
    ok = (result["routes"]["f32"]["e2e_equals_kernels"]
          and result["routes"]["q13"]["e2e_equals_kernels"]
          and result["routes"]["q13"]["equals_engine"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
