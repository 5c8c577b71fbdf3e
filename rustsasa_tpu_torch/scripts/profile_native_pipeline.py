"""Stage split of the batch pipeline's native host route, each stage alone.

Port of `scripts/profile_native_pipeline.py`:

    python -m rustsasa_tpu_torch.scripts.profile_native_pipeline \\
        [corpus_dir] [limit] [--device cuda|cpu]

On `limit` files (1,024) taken at an even stride through the corpus (the
port's bench corpus, built under build/rustsasa_tpu_torch/bench/ when
absent), it times what `process_directory` does on its native route:

  load    : native_process_file per file on a pool of min(32, 2 x CPUs)
            threads (GIL-free C++ parse and residue-level selection);
  pack    : pack_structures, the host-cull f32 packer (Morton order and
            the host tile cull);
  device  : engine.compute, the first call;
  device2 : engine.compute again, warm.  Both include the engine's own
            packing (fastpack_q13 on the banded q13 wire), the copies to
            the card, dequant, the banded cull, kernel 1 and the readback;
  emit    : NativeSelection.emit of residue JSON per file on the pool;
            each handle is closed after its emit.

Host stages run on the host clock (`perf_counter`); the device stages
stop after a synchronize of every card the engine holds.  The engine is
built on `device` first, so without CUDA the default raises before any
stage runs.  Outputs go to build/rustsasa_tpu_torch/profile/native_out/.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from ..ops import fused_kernel as fk
from . import _study

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "rustsasa_tpu_torch", "profile",
    "native_out")
LIMIT = 1024


def _load(path):
    from ..native import native_process_file

    return native_process_file(
        path, level="residue", include_hydrogens=False,
        include_hetatms=False, read_radii_from_occupancy=False,
        allow_vdw_fallback=False,
    )


def run(corpus_dir=None, limit: int = LIMIT, device="cuda",
        out_dir: str = OUT) -> dict:
    """The five stages on `limit` strided corpus files; returns their
    seconds (load_s, pack_s, device_s, device2_s, emit_s), the sum of
    load, device2 and emit (sum_s, with its Matoms/s), the chunk shape
    (m, avg_jtiles), the counts (files, atoms, workers) and where it ran
    (cpu_count, gpu_name, power_limit)."""
    from ..ops.engine import BatchedSasaEngine, SasaParams

    engine = BatchedSasaEngine(SasaParams(), device=device)
    all_files = _study.corpus_files(corpus_dir)
    step = max(1, len(all_files) // limit)
    files = all_files[::step][:limit]
    os.makedirs(out_dir, exist_ok=True)
    workers = min(32, (os.cpu_count() or 4) * 2)
    out = {"files": len(files), "workers": workers,
           **_study.where(engine.device)}
    with ThreadPoolExecutor(max_workers=workers) as pool:
        t0 = time.perf_counter()
        handles = list(pool.map(_load, files))
        out["load_s"] = time.perf_counter() - t0
        try:
            out["atoms"] = sum(h.coords.shape[0] for h in handles)
            triples = [(h.coords, h.radii, h.gids) for h in handles]

            t0 = time.perf_counter()
            packed = fk.pack_structures(triples, 1.4, 100)
            out["pack_s"] = time.perf_counter() - t0
            nt = packed[0].shape[1] // fk.ATOM_TILE
            out["m"] = packed[0].shape[1]
            out["avg_jtiles"] = float(packed[1][:nt, 0].mean())
            del packed

            for key in ("device_s", "device2_s"):
                _study.synchronize(engine.ring.devices)
                t0 = time.perf_counter()
                outs = engine.compute(triples)
                _study.synchronize(engine.ring.devices)
                out[key] = time.perf_counter() - t0

            def emit(args):
                i, h, sasa = args
                h.emit(sasa, "residue", "json",
                       os.path.join(out_dir, f"{i}.json"))
                h.close()

            t0 = time.perf_counter()
            list(pool.map(emit, [(i, h, o) for i, (h, o)
                                 in enumerate(zip(handles, outs))]))
            out["emit_s"] = time.perf_counter() - t0
        finally:
            for h in handles:
                h.close()
    out["sum_s"] = out["load_s"] + out["device2_s"] + out["emit_s"]
    out["matoms_s"] = out["atoms"] / out["sum_s"] / 1e6
    return out


def lines(r: dict) -> list[str]:
    """The reference's lines for a run() result, then where it ran."""
    return [
        f"load    {r['load_s']:7.2f}s  ({r['files']} files, {r['atoms']} "
        f"atoms, {r['workers']} workers)",
        f"pack    {r['pack_s']:7.2f}s  (M={r['m']}, avg j-tiles "
        f"{r['avg_jtiles']:.1f})",
        f"device  {r['device_s']:7.2f}s  (first call)",
        f"device2 {r['device2_s']:7.2f}s  (warm, incl. pack; "
        f"{r['atoms'] / r['device2_s'] / 1e6:.2f} Matoms/s)",
        f"emit    {r['emit_s']:7.2f}s",
        f"sum(load+device2+emit) = {r['sum_s']:.2f}s for {r['files']} files "
        f"/ {r['atoms']} atoms ({r['matoms_s']:.2f} Matoms/s serial-sum)",
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
