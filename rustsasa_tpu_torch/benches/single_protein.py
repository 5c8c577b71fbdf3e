#!/usr/bin/env python
"""Single-protein latency bench of the port (reference: paper/paper.md:43).

    python -m rustsasa_tpu_torch.benches.single_protein [structure] \\
        [--device cuda|cpu]

The reference pins 4.0 ms +- 0.5 for one AlphaFold-scale protein
(hyperfine, 3 warmup + 25 runs of the full CLI on an M3 laptop,
paper/eval/benchmark.sh:5).  A Rust binary's process startup is ~1 ms,
so their number is effectively the warm pipeline latency.  The quantity
here is the warm in-process latency of the CLI's single-file route
(`cli._run_single_native`): native parse + select, the engine on the
device, native emit of residue JSON; and of the whole in-process
`cli.main` call that wraps it.  25 reps after 3 warm ones; best and
median, beside the card's `nvidia-smi` name and power limit.  The
floor is one tiny device op and its readback.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# ~2.6k atoms - the same scale as AF-A0A385XJ53 (an average E. coli
# protein).
EXAMPLE = os.path.join(REPO, "tests", "data", "pdbs", "example.cif")
REPS = 25
WARM = 3


def run(path=EXAMPLE, device="cuda") -> dict:
    import torch

    from ..cli import main as cli_main
    from ..native import native_process_file, pipe_library
    from ..ops.engine import BatchedSasaEngine, SasaParams
    from ..utils.card import nvidia_smi

    if pipe_library() is None:
        raise RuntimeError("the native library is required for this bench")
    engine = BatchedSasaEngine(SasaParams(), device=device)
    dev = engine.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with tempfile.TemporaryDirectory(prefix="rustsasa_single_") as tmp:
        out_path = os.path.join(tmp, "out.json")

        def route():
            t = {}
            t0 = time.perf_counter()
            ns = native_process_file(
                path, level="residue", include_hydrogens=False,
                include_hetatms=False, read_radii_from_occupancy=False,
                allow_vdw_fallback=False,
            )
            t["parse_select"] = time.perf_counter() - t0
            try:
                t0 = time.perf_counter()
                (sasa,) = engine.compute([(ns.coords, ns.radii, ns.gids)])
                t["device"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                ns.emit(sasa, "residue", "json", out_path)
                t["emit"] = time.perf_counter() - t0
            finally:
                ns.close()
            t["total"] = sum(t.values())
            return t

        def cli():
            t0 = time.perf_counter()
            # The CLI's progress lines would mix with this bench's JSON.
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli_main([path, out_path, "--device", str(device)])
            if rc != 0:
                raise RuntimeError("the CLI failed")
            return {"cli_main": time.perf_counter() - t0}

        def floor():
            t0 = time.perf_counter()
            (torch.ones(128, device=dev) * 2.0).cpu()
            return {"floor": time.perf_counter() - t0}

        runs = {}
        for fn in (route, cli, floor):
            for _ in range(WARM):
                fn()
            sync()
            for _ in range(REPS):
                for k, v in fn().items():
                    runs.setdefault(k, []).append(v * 1e3)
    card = nvidia_smi() if dev.type == "cuda" else None
    where = f"{card[0]}, {card[1]}" if card else str(dev)
    print(f"single-protein latency over {REPS} reps ({path}) on {where}:",
          file=sys.stderr)
    for k, vals in runs.items():
        print(f"  {k:12s} best {min(vals):8.3f} ms   median "
              f"{statistics.median(vals):8.3f} ms", file=sys.stderr)
    med = statistics.median(runs["total"])
    floor_med = statistics.median(runs["floor"])
    return {
        "metric": "single_protein_residue_sasa_warm_latency",
        "value": med,
        "unit": "ms",
        "reference_ms": 4.0,
        "best_ms": min(runs["total"]),
        "stages_median_ms": {k: statistics.median(v)
                             for k, v in runs.items()},
        "floor_ms": floor_med,
        "above_floor_ms": med - floor_med,
        "device": str(dev),
        "gpu_name": card[0] if card else None,
        "power_limit": card[1] if card else None,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("structure", nargs="?", default=EXAMPLE)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(run(args.structure, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
