"""Kernel 1 alone on packed corpus data, on the card.

Port of `scripts/profile_fused.py`:

    python -m rustsasa_tpu_torch.scripts.profile_fused \\
        [corpus_dir] [limit] [--device cuda|cpu]

Selects the first `limit` files (512) of the corpus in name order at
residue level (the port's bench corpus, built under
build/rustsasa_tpu_torch/bench/ when absent), packs them with
pack_structures (the host-cull f32 wire: real group ids, j-lists culled
on the host), pads the slots to the reference engine's M buckets (padded
tiles carry empty j-lists) and times `fused_kernel.fused_sasa` (kernel 1
and the per-slot areas) on tensors already on the device: one warm call,
then the best of three, each between two CUDA events.

Reports milliseconds, ns per j-iteration (j-list entries x 128 i-atoms),
cycles per j-iteration at the H100's 1.98 GHz boost clock, Matoms/s, and
FP32 instructions/s at the work the inputs need (fused_kernel.
needed_instructions of reach_work: 7 a point for each in-reach pair of
real atoms and the reach test for each admitted pair, as chip_smoke.py
bounds kernel 1) against the 33.5T/s issue peak, whose share of it is
the kernel's share of its bound.  The reference fed four jittered copies
of the planes to defeat its TPU link's memo of repeated calls; CUDA has
none, so one set of tensors serves.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..ops import fused_kernel as fk
from ..ops.neighbors import _round_bucket
from . import _study

LIMIT = 512
N_POINTS = 100
# The reference engine's slot buckets (rustsasa_tpu/ops/engine.py:433);
# the port's engine takes any multiple of 128 slots and has none.
FUSED_M_BUCKETS = [2048, 4096, 8192, 32768, 131072, 524288, 1048576, 2097152]
CLOCK_HZ = 1.98e9
FP32_INSTR_PER_S = 33.5e12


def packed_inputs(corpus_dir=None, limit: int = LIMIT):
    """(planes5 [5, M_pad] f32, jlist [M_pad/128, JLIST_ROWS] u32, m,
    atoms, files, failed) of the first `limit` corpus files, selected as
    the reference script selects them and padded to FUSED_M_BUCKETS."""
    from ..api import SASAOptions
    from ..io.read import read_structure
    from ..levels import Level

    files = _study.corpus_files(corpus_dir)[:limit]
    options = SASAOptions(level=Level.RESIDUE)
    triples = []
    for f in files:
        sel = options.build_selection(read_structure(f))
        triples.append((sel.coords, sel.radii, sel.group_ids))
    planes, jlist, _offsets, failed = fk.pack_structures(triples, 1.4,
                                                         N_POINTS)
    m = planes.shape[1]
    m_pad = _round_bucket(m, FUSED_M_BUCKETS)
    planes = np.pad(planes, ((0, 0), (0, m_pad - m)))
    jlist = np.pad(jlist, ((0, (m_pad - m) // fk.ATOM_TILE), (0, 0)))
    atoms = sum(t[0].shape[0] for t in triples)
    return planes, jlist, m, atoms, len(files), len(failed)


def run(corpus_dir=None, limit: int = LIMIT, device="cuda",
        reps: int = 3) -> dict:
    """Packs and times as the module docstring says.  Returns the shape
    (files, atoms, m, m_pad, tiles, failed, avg_jtiles, jiters), the work
    (admitted_pairs, reach_pairs, streamed_pairs: (i, j) pairs of real
    atoms admitted, in reach, and in the rows the kernel streams;
    margins: the in-reach pairs x N_POINTS; instr), the timings
    (pack_s, first_ms, ms, ns_per_jiter, cycles_per_jiter, matoms_s,
    fp32_instr_per_s, peak_share, bound_ms), where it ran (cpu_count,
    gpu_name, power_limit) and the last call's per-slot SASA (`sasa`,
    numpy [M_pad] f32)."""
    from ..ops import engine

    dev = engine.resolve_devices(device)[0]
    t0 = time.perf_counter()
    planes, jlist, m, atoms, n_files, failed = packed_inputs(corpus_dir,
                                                             limit)
    pack_s = time.perf_counter() - t0
    tiles = m // fk.ATOM_TILE
    jiters = int(jlist[:, 0].astype(np.int64).sum()) * fk.ATOM_TILE
    planes_d, jlist_d = fk.to_device((planes, jlist), dev)
    sphere = engine._sphere_device(N_POINTS, dev)
    work = fk.reach_work(planes_d, jlist_d, sphere)
    instr = fk.needed_instructions(work, N_POINTS)
    first_ms, ms, out = _study.timed(
        lambda: fk.fused_sasa(planes_d, jlist_d, sphere, n_points=N_POINTS),
        dev, reps)
    rate = instr / (ms * 1e-3)
    return {
        "files": n_files, "atoms": atoms, "m": m, "m_pad": planes.shape[1],
        "tiles": tiles, "failed": failed,
        "avg_jtiles": float(jlist[:tiles, 0].mean()), "jiters": jiters,
        "admitted_pairs": work["admitted"], "reach_pairs": work["reach"][1],
        "streamed_pairs": work["kept"],
        "margins": work["reach"][1] * N_POINTS, "instr": instr,
        "pack_s": pack_s, "first_ms": first_ms,
        "ms": ms, "ns_per_jiter": ms * 1e6 / jiters,
        "cycles_per_jiter": ms * 1e-3 / jiters * CLOCK_HZ,
        "matoms_s": atoms / (ms * 1e-3) / 1e6, "fp32_instr_per_s": rate,
        "peak_share": rate / FP32_INSTR_PER_S,
        "bound_ms": instr / FP32_INSTR_PER_S * 1e3, **_study.where(dev),
        "sasa": out.cpu().numpy(),
    }


def lines(r: dict) -> list[str]:
    """The reference's lines for a run() result, then the instruction
    rate and where it ran."""
    return [
        f"pack {r['pack_s']:.2f}s  failed={r['failed']}",
        f"{r['files']} files, {r['atoms']} atoms, {r['tiles']} tiles (pad "
        f"{r['m_pad']}), avg j-tiles/i-tile {r['avg_jtiles']:.1f}, "
        f"{r['jiters'] / 1e6:.1f}M j-iters",
        f"first call {r['first_ms'] / 1e3:.2f}s  total="
        f"{float(r['sasa'].sum()):.1f}",
        f"warm {r['ms']:.3f}ms -> {r['ns_per_jiter']:.3f} ns/j-iter "
        f"({r['cycles_per_jiter']:.2f} cycles at 1.98 GHz), "
        f"{r['matoms_s']:.2f} Matoms/s device-only",
        f"j-atoms an atom: {r['admitted_pairs'] / r['atoms']:.1f} admitted, "
        f"{r['reach_pairs'] / r['atoms']:.1f} in reach, "
        f"{r['streamed_pairs'] / r['atoms']:.1f} streamed",
        f"{r['instr'] / 1e9:.3f}G FP32 instructions needed ("
        f"{fk.INSTR_PER_MARGIN} a margin in reach, "
        f"{fk.REACH_INSTR_PER_PAIR} a reach test): "
        f"{r['fp32_instr_per_s'] / 1e12:.2f}T/s, {r['peak_share']:.3f} of "
        f"the 33.5T/s issue peak (bound {r['bound_ms']:.3f} ms)",
        _study.where_line(r),
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("corpus_dir", nargs="?", default=None)
    p.add_argument("limit", nargs="?", type=int, default=LIMIT)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for line in lines(run(args.corpus_dir, args.limit, args.device)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
