"""Stage split of the batch pipeline's Python host route, each stage alone.

Port of `scripts/profile_pipeline.py`:

    python -m rustsasa_tpu_torch.scripts.profile_pipeline \\
        [corpus_dir] [limit] [--device cuda|cpu]

On the first `limit` files (1,024) of the corpus in name order (the
port's bench corpus, built under build/rustsasa_tpu_torch/bench/ when
absent), it times:

  parse   : read_structure per file on a pool of min(32, 2 x CPUs)
            threads;
  select  : SASAOptions.build_selection per structure (residue level);
  pack    : pack_structures, the host-cull f32 packer;
  device  : engine.compute, the first call;
  device2 : engine.compute again, warm (both include the engine's own
            packing, the copies, the cull, kernel 1 and the readback);
  emit    : fast_selection_json and the file write, per file on the pool.

Host stages run on the host clock (`perf_counter`); the device stages
stop after a synchronize of every card the engine holds.  The engine is
built on `device` first, so without CUDA the default raises before any
stage runs.  Outputs go to build/rustsasa_tpu_torch/profile/python_out/.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from ..ops import fused_kernel as fk
from . import _study
from .profile_native_pipeline import LIMIT

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "rustsasa_tpu_torch", "profile",
    "python_out")


def run(corpus_dir=None, limit: int = LIMIT, device="cuda",
        out_dir: str = OUT) -> dict:
    """The six stages on the first `limit` corpus files; returns their
    seconds (parse_s, select_s, pack_s, device_s, device2_s, emit_s), the
    sum of parse, select, device2 and emit (sum_s), the packed slots (m),
    the counts (files, atoms, workers) and where it ran (cpu_count,
    gpu_name, power_limit)."""
    from ..api import SASAOptions
    from ..io.read import read_structure
    from ..io.serialize import fast_selection_json
    from ..levels import Level
    from ..ops.engine import BatchedSasaEngine, SasaParams

    engine = BatchedSasaEngine(SasaParams(), device=device)
    files = _study.corpus_files(corpus_dir)[:limit]
    os.makedirs(out_dir, exist_ok=True)
    options = SASAOptions(level=Level.RESIDUE, device=device)
    workers = min(32, (os.cpu_count() or 4) * 2)
    out = {"files": len(files), "workers": workers,
           **_study.where(engine.device)}
    with ThreadPoolExecutor(max_workers=workers) as pool:
        t0 = time.perf_counter()
        structures = list(pool.map(read_structure, files))
        out["parse_s"] = time.perf_counter() - t0
        out["atoms"] = sum(s.n_atoms() for s in structures)

        t0 = time.perf_counter()
        sels = list(pool.map(options.build_selection, structures))
        out["select_s"] = time.perf_counter() - t0
        triples = [(s.coords, s.radii, s.group_ids) for s in sels]

        t0 = time.perf_counter()
        out["m"] = fk.pack_structures(triples, 1.4, 100)[0].shape[1]
        out["pack_s"] = time.perf_counter() - t0

        for key in ("device_s", "device2_s"):
            _study.synchronize(engine.ring.devices)
            t0 = time.perf_counter()
            outs = engine.compute(triples)
            _study.synchronize(engine.ring.devices)
            out[key] = time.perf_counter() - t0

        def emit(args):
            i, sel, sasa = args
            payload = fast_selection_json(sel, sasa, Level.RESIDUE)
            with open(os.path.join(out_dir, f"{i}.json"), "w") as f:
                f.write(payload)

        t0 = time.perf_counter()
        list(pool.map(emit, [(i, s, o) for i, (s, o)
                             in enumerate(zip(sels, outs))]))
        out["emit_s"] = time.perf_counter() - t0
    out["sum_s"] = (out["parse_s"] + out["select_s"] + out["device2_s"]
                    + out["emit_s"])
    return out


def lines(r: dict) -> list[str]:
    """The reference's lines for a run() result, then where it ran."""
    return [
        f"{r['files']} files",
        f"parse   {r['parse_s']:7.2f}s  ({r['atoms']} atoms, "
        f"{r['workers']} workers)",
        f"select  {r['select_s']:7.2f}s",
        f"pack    {r['pack_s']:7.2f}s  (M={r['m']})",
        f"device  {r['device_s']:7.2f}s  (first call, incl. pack+transfer)",
        f"device2 {r['device2_s']:7.2f}s  (second run, warm)",
        f"emit    {r['emit_s']:7.2f}s",
        f"sum(parse+select+device2+emit) = {r['sum_s']:.2f}s for "
        f"{r['files']} files / {r['atoms']} atoms",
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
