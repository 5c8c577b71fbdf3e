"""The first launch and warm throughput of every production chunk shape,
on the card.

Port of `scripts/precompile_fused.py`:

    python -m rustsasa_tpu_torch.scripts.precompile_fused [--quick] \\
        [--device cuda|cpu]

The reference compiled each (M, w) shape bucket into XLA's persistent
cache and reported warm throughput a bucket.  On the card nothing is
left to compile once the kernels are built, so this script builds them
first, timed apart; then it times the first launch of each production
chunk shape (`BatchedSasaEngine.warm_shapes`, one shape at a time, in
this process's first launches: the kernels' module loads and the
caching allocator's growth) and the same again warm; then it runs the
reference's rows on the port's engine with its seeded structures
(`protein_like`: uniform coordinates
at about a folded protein's density, radii from the ProtOr-like `RSET`,
one `default_rng(0)` for the whole run):

  bucket : every M bucket of the reference engine, filled with
           2,000-atom structures (w = 16);
  w-band : the 25 rows whose largest structure (2,600 to 16,000 atoms)
           sets the band width (24, 32, 64 or 127), the rest 2,000-atom
           structures;
  q16    : the 8 rows whose largest structure spans 200 A, past the q13
           wire's extent (fused_kernel.MAX_Q13_EXTENT, 100 A), so that it
           takes the q16 wire; the engine splits the rest onto q13 as a
           chunk of their own.

After the shapes one at a time, all nine shapes go through
`warm_shapes` warm, one thread a shape and serially, in the order
pool, serial, serial, pool.

Each row is one `BatchedSasaEngine.compute` on the same structures three
times: the first call (on the card the kernels' module loads and the
caching allocator's growth) and two warm calls, each on the host clock
from packing to readback, in ms and Matoms/s, with each call's kernel
launches and route chunks.  Launches are counted from 0 at the start of
the run: every warm_shapes call and every row call carries its own, and
the JSON line carries the process's totals.  The rows of 4,194,304
slots exceed the engine's chunk budget (CHUNK_SLOT_BUDGET, 2,097,152):
the engine splits them into chunks, and the output says so.  The last
line is one JSON object of the rows.  `--quick` runs one row for each
wire and each of w = 16, 32 and 127, from a fresh `default_rng(0)`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np

from ..ops import _kernels, engine
from ..ops.fused_kernel import ATOM_TILE
from . import _study
from .profile_fused import FUSED_M_BUCKETS

# Discrete radii (ProtOr-like set): the q13 palette stays small, as for
# every real structure.
RSET = np.array([1.42, 1.55, 1.61, 1.64, 1.77, 1.88, 2.0], np.float32)
# Atoms a bucket row's structures hold, and the atom slots a structure
# is counted at when the rows are filled.
FILL_ATOMS = 2000
FILL_SLOTS = 2048
# (M, atoms of the largest structure) of the w-band rows and (M, atoms,
# atoms of the 200 A structure) of the q16 rows, as the reference lists
# them.
W_BAND_ROWS = [
    (4096, 2600), (4096, 4000), (8192, 2600), (32768, 2600), (131072, 2600),
    (524288, 2600), (1048576, 2600), (2097152, 2600),
    (8192, 4000), (32768, 4000), (131072, 4000),
    (524288, 4000), (1048576, 4000), (2097152, 4000),
    (8192, 5000), (32768, 12000),
    (32768, 8000), (131072, 8000), (524288, 8000),
    (2097152, 8000), (4194304, 8000),
    (131072, 16000), (524288, 16000),
    (2097152, 16000), (4194304, 16000),
]
Q16_ROWS = [
    (2097152, 2600, 2600), (2097152, 4000, 4000),
    (1048576, 4000, 4000), (524288, 4000, 4000),
    (32768, 5000, 5000), (131072, 16000, 16000),
    (2048, 2000, 2000), (8192, 2600, 2600),
]
Q16_EXTENT = 200.0
KERNELS = ("dequant_boxes", "band_jlist", "fused_count")
WARM_CALLS = 2


class Row(NamedTuple):
    """One row: its kind ("bucket", "w-band" or "q16"), M, and the
    atoms of its largest structure (none for a bucket row)."""

    kind: str
    m: int
    big: int | None = None

    @property
    def label(self) -> str:
        if self.kind == "bucket":
            return f"bucket {self.m}"
        if self.kind == "w-band":
            return f"bucket {self.m} w-band({self.big} atoms)"
        return f"bucket {self.m} q16({self.big} atoms)"


def all_rows() -> list[Row]:
    """Every row of the reference script, in its order."""
    return ([Row("bucket", m) for m in FUSED_M_BUCKETS]
            + [Row("w-band", m, n) for m, n in W_BAND_ROWS]
            + [Row("q16", m, w_n) for m, _n, w_n in Q16_ROWS])


# --quick: q13 at w = 16, 32, 127, then q16 at w = 16, 32, 127 (the
# largest structure's tiles pick the width).
QUICK_ROWS = [
    Row("bucket", 8192), Row("w-band", 4096, 4000),
    Row("w-band", 32768, 12000), Row("q16", 2048, 2000),
    Row("q16", 524288, 4000), Row("q16", 131072, 16000),
]


def protein_like(rng, n: int, extent: float | None = None):
    """(coords, radii, None) of `n` atoms uniform in a cube (of side
    `extent`, or at 0.1 atoms per cubic angstrom), radii from RSET."""
    side = extent if extent is not None else (n / 0.1) ** (1 / 3)
    c = rng.uniform(0, side, (n, 3)).astype(np.float32)
    r = rng.choice(RSET, n).astype(np.float32)
    return c, r, None


def row_structures(rng, row: Row) -> list:
    """The structures the reference builds for `row`."""
    if row.kind == "bucket":
        return [protein_like(rng, FILL_ATOMS)
                for _ in range(max(1, row.m // FILL_SLOTS))]
    extent = Q16_EXTENT if row.kind == "q16" else None
    out = [protein_like(rng, row.big, extent=extent)]
    out += [protein_like(rng, FILL_ATOMS)
            for _ in range(max(0, (row.m - 2 * row.big) // FILL_SLOTS))]
    return out


def _launches() -> dict:
    return {k: _kernels.launch_counts[k] for k in KERNELS}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _warm(eng, shapes=None, threads=None) -> tuple[float, dict]:
    """warm_shapes(shapes, threads=threads): (seconds, launches)."""
    before = _launches()
    return eng.warm_shapes(shapes, threads=threads), _since(before)


def run(device="cuda", *, quick: bool = False, rows=None,
        say=lambda line: None) -> dict:
    """Builds the kernels (on a card), warms the shapes, then runs
    `rows` (default: every row, or QUICK_ROWS with `quick`); `say` takes
    each line.  Returns {"build_s", "shapes": [{"m", "w", "first_s",
    "warm_s", "launches": [first, again]}] (0.0 s on the CPU),
    "pool_vs_serial": [{"threads", "s", "launches"}] (all the shapes,
    warm), "rows": [{"label", "kind", "m", "big", "structures", "atoms",
    "slots", "calls": [{"ms", "routes", "launches"}], "first_ms",
    "warm_ms": [2], "matoms_s": [2], "routes", "chunks", "split",
    "launches"}], "launches": the process's total a kernel, and where it
    ran}.  A row's `routes` and `chunks` are its first call's, its
    `launches` the sum over its calls; `slots`: the atom slots the
    engine packs the row into (the structures' tiles); `split`: the row
    exceeds one chunk's budget."""
    _kernels.reset_launch_counts()
    dev = engine.resolve_devices(device)[0]
    build_s = 0.0
    if dev.type == "cuda":
        t0 = time.perf_counter()
        _kernels.build()
        build_s = time.perf_counter() - t0
        say(f"kernels built in {build_s:.1f}s")
    eng = engine.BatchedSasaEngine(engine.SasaParams(), backend="fused",
                                   device=dev)
    shapes = []
    for m, w in eng._WARM_SHAPES:
        first_s, first = _warm(eng, [(m, w)], threads=1)
        shapes.append({"m": m, "w": w, "first_s": first_s,
                       "launches": [first]})
    for rec in shapes:
        rec["warm_s"], again = _warm(eng, [(rec["m"], rec["w"])], threads=1)
        rec["launches"].append(again)
        say(f"warm_shapes M={rec['m']} w={rec['w']}: first "
            f"{rec['first_s'] * 1e3:.3f}ms, again {rec['warm_s'] * 1e3:.3f}ms;"
            f" launches {rec['launches']}")
    pool_vs_serial = []
    for threads in (None, 1, 1, None):
        s, launches = _warm(eng, threads=threads)
        pool_vs_serial.append({"threads": threads, "s": s,
                               "launches": launches})
        say(f"warm_shapes, all {len(eng._WARM_SHAPES)} shapes, "
            f"{'one thread a shape' if threads is None else 'serially'}: "
            f"{s * 1e3:.3f}ms; launches {launches}")
    rng = np.random.default_rng(0)
    out = []
    for row in (rows if rows is not None
                else QUICK_ROWS if quick else all_rows()):
        structures = row_structures(rng, row)
        atoms = sum(s[0].shape[0] for s in structures)
        slots = sum(-(-s[0].shape[0] // ATOM_TILE) * ATOM_TILE
                    for s in structures)
        calls = []
        for _ in range(1 + WARM_CALLS):
            routes0, launches0 = dict(eng.routes.counts), _launches()
            t0 = time.perf_counter()
            eng.compute(structures)
            ms = (time.perf_counter() - t0) * 1e3
            calls.append({
                "ms": ms,
                "routes": {k: v - routes0[k]
                           for k, v in eng.routes.counts.items()
                           if v > routes0[k]},
                "launches": _since(launches0)})
        times = [c["ms"] for c in calls]
        rec = {
            "label": row.label, "kind": row.kind, "m": row.m, "big": row.big,
            "structures": len(structures), "atoms": atoms, "slots": slots,
            "calls": calls, "first_ms": times[0], "warm_ms": times[1:],
            "matoms_s": [atoms / (t * 1e-3) / 1e6 for t in times[1:]],
            "routes": calls[0]["routes"],
            "chunks": sum(calls[0]["routes"].values()),
            "split": slots > engine.CHUNK_SLOT_BUDGET,
            "launches": {k: sum(c["launches"][k] for c in calls)
                         for k in KERNELS},
        }
        out.append(rec)
        say(line(rec))
    return {"build_s": build_s, "shapes": shapes,
            "pool_vs_serial": pool_vs_serial, "rows": out,
            "launches": dict(_kernels.launch_counts), **_study.where(dev)}


def line(rec: dict) -> str:
    """The reference's line for a row, with its first call, its route
    and each call's launches."""
    warm = ", ".join(f"{t:.1f}ms ({r:.2f} Matoms/s)"
                     for t, r in zip(rec["warm_ms"], rec["matoms_s"]))
    split = (f"; {rec['slots']} slots exceed the "
             f"{engine.CHUNK_SLOT_BUDGET}-slot chunk budget: split into "
             f"{rec['chunks']} chunks"
             if rec["split"] else "")
    launches = {k: [c["launches"][k] for c in rec["calls"]]
                for k in rec["launches"]}
    return (f"{rec['label']}: first call {rec['first_ms']:.1f}ms, warm "
            f"{warm} for {rec['atoms']} atoms; routes {rec['routes']}, "
            f"launches a call {launches}{split}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    result = run(args.device, quick=args.quick,
                 say=lambda s: print(s, flush=True))
    print(_study.where_line(result), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
