#!/usr/bin/env python
"""The 88-PDB FreeSASA quality gate through the port, as a JSON artifact.

The port's counterpart of `scripts/quality_gate.py`: runs the gate
(reference: tests/quality.rs:17-18,138-233, RMSE baseline 43.99 + 20
tolerance) at all four output depths plus the occupancy-radii path
through the port's production pipeline on `--device` ("cuda" by
default), so the card's kernels, not only the CPU's plain versions,
are held to FreeSASA.

Usage:
    python -m rustsasa_tpu_torch.scripts.quality_gate [--out PATH] \\
        [--device cuda|cpu]
Default output: build/rustsasa_tpu_torch/quality_latest.json.  Exits 1
when any row fails.
"""

import argparse
import json
import math
import os
import sys

from .quality_report import REPO, evaluate_depth, evaluate_occupancy

RMSE_LIMIT = 43.99 + 20.0  # reference: tests/quality.rs:17-18
DEFAULT_OUT = os.path.join(REPO, "build", "rustsasa_tpu_torch",
                           "quality_latest.json")


def _row(r: dict) -> dict:
    if not math.isfinite(r["rmse"]):
        r["rmse"] = 1e30  # JSON-safe sentinel; pass stays False below
    if not math.isfinite(r["pearson_r"]):
        r["pearson_r"] = 0.0  # degenerate correlation; keep JSON strict
    row = {
        "depth": r["depth"],
        "n": r["n"],
        "n_files": r["n_files"],
        "n_ok": r["n_ok"],
        "n_errors": len(r["errors"]),
        "rmse": round(r["rmse"], 4),
        "pearson_r": round(r["pearson_r"], 6),
        "pass": bool(r["rmse"] <= RMSE_LIMIT and r["n_ok"] == r["n_files"]),
    }
    if r["errors"]:
        row["errors"] = r["errors"][:10]
    return row


def run_gate(device="cuda") -> dict:
    """All four output depths + the occupancy-radii path through the
    port's pipeline on `device` (the reference runs its gate at all
    depths too, quality.rs:224-257, plus the -R test :260-442).  The
    depths differ in gid semantics (protein-level drops alt-loc), which
    is where a fault of one wire would hide."""
    import torch

    from ..utils.card import nvidia_smi

    rows = [
        _row(evaluate_depth(d, device=device))
        for d in ("residue", "atom", "chain", "protein")
    ]
    rows.append(_row(evaluate_occupancy(device=device)))
    residue = rows[0]
    dev = torch.device(device)
    card = nvidia_smi() if dev.type == "cuda" else None
    return {
        "gate": "freesasa_88pdb_rmse_all_depths",
        "device": str(dev),
        "platform": dev.type,
        "gpu_name": card[0] if card else None,
        "power_limit": card[1] if card else None,
        "rmse_limit": RMSE_LIMIT,
        # Top-level n/rmse/pearson_r mirror the residue row (the
        # historical single-depth schema); `pass` requires EVERY row.
        "n": residue["n"],
        "n_files": residue["n_files"],
        "n_ok": residue["n_ok"],
        "n_errors": residue["n_errors"],
        "rmse": residue["rmse"],
        "pearson_r": residue["pearson_r"],
        "rows": rows,
        "pass": all(row["pass"] for row in rows),
    }


def write_artifact(result: dict, out_path: str = DEFAULT_OUT) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    result = run_gate(args.device)
    write_artifact(result, args.out)
    print(json.dumps(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
