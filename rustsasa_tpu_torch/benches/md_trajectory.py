#!/usr/bin/env python
"""MD-trajectory bench of the port (reference: paper/paper.md:45,
mdsasa-bolt).

    python -m rustsasa_tpu_torch.benches.md_trajectory \\
        [topology] [n_frames] [--device cuda|cpu]

The reference's companion package processes GPCRmd trajectory 10824
(4IAQ 5-HT1B receptor) in 22.7 s +- 1.4 (hyperfine, 3 runs, 8-core M3).
The trajectory itself is not in the repository, so this bench
synthesizes a GPCRmd-shaped workload: a receptor-sized topology
(example.cif, 2,622 heavy atoms) and a DCD of per-frame thermal jitter
(0.3 A RMS, seed 0) around its coordinates, written to a temporary file,
then streams it through `compute_trajectory_sasa` on the device: static
topology and radii resolved once, frame blocks batched through the
count kernel, vectorized per-frame residue sums.  Default 2,500 frames
(the typical GPCRmd stride).

Prints a first (warm) pass and a timed pass: seconds, ms a frame and
Matoms/s beside the card's `nvidia-smi` name and power limit, then one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOPOLOGY = os.path.join(REPO, "tests", "data", "pdbs", "example.cif")
N_FRAMES = 2500
REFERENCE_S = 22.7  # paper.md:45


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def jitter_frames(topology: str, n_frames: int, seed: int = 0) -> np.ndarray:
    """[n_frames, N, 3] f32: the topology's coordinates plus independent
    N(0, 0.3 A) noise per frame and axis - the compute shape of a real MD
    trajectory (0.3 A perturbations keep protein-like packing)."""
    from ..io.read import read_structure

    base = read_structure(topology).atoms.coords.astype(np.float32)
    rng = np.random.default_rng(seed)
    return base[None, :, :] + rng.normal(
        0.0, 0.3, size=(n_frames, base.shape[0], 3)
    ).astype(np.float32)


def run(topology=TOPOLOGY, n_frames=N_FRAMES, device="cuda", dcd_path=None,
        say=log) -> dict:
    """Write the jittered DCD (to `dcd_path`, or a temporary file that is
    removed afterwards), time a warm and a timed pass of
    `compute_trajectory_sasa` on `device`, and return the JSON record
    with the timed pass's result under "result" (not serialized)."""
    from ..api import SASAOptions
    from ..levels import Level
    from ..trajectory import compute_trajectory_sasa, write_dcd
    from ..utils.card import nvidia_smi

    frames = jitter_frames(topology, n_frames)
    n_atoms = frames.shape[1]
    options = SASAOptions(level=Level.RESIDUE, device=device)
    with tempfile.TemporaryDirectory(prefix="rustsasa_md_bench_") as tmp:
        path = dcd_path or os.path.join(tmp, "traj.dcd")
        write_dcd(path, frames)
        say(f"synthetic trajectory: {n_frames} frames x {n_atoms} atoms "
            f"({os.path.getsize(path) / 1e6:.0f} MB DCD)")
        t0 = time.perf_counter()
        compute_trajectory_sasa(topology, path, options)
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        result = compute_trajectory_sasa(topology, path, options)
        elapsed = time.perf_counter() - t0
    card = nvidia_smi() if str(device).startswith("cuda") else None
    where = f"{card[0]}, {card[1]}" if card else str(device)
    matoms = n_frames * n_atoms / elapsed / 1e6
    say(f"first pass {warm_s:.3f}s; timed pass {elapsed:.3f}s "
        f"({elapsed / n_frames * 1e3:.4f} ms/frame, {matoms:.3f} Matoms/s) "
        f"on {where}")
    return {
        "metric": "md_trajectory_residue_sasa_wall",
        "value": elapsed,
        "unit": "s",
        "frames": n_frames,
        "atoms_per_frame": n_atoms,
        "ms_per_frame": elapsed / n_frames * 1e3,
        "matoms_per_s": matoms,
        "warmup_s": warm_s,
        "reference_s": REFERENCE_S,
        "vs_reference": REFERENCE_S / elapsed,
        "device": str(device),
        "gpu_name": card[0] if card else None,
        "power_limit": card[1] if card else None,
        "result": result,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("topology", nargs="?", default=TOPOLOGY)
    p.add_argument("n_frames", nargs="?", type=int, default=N_FRAMES)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    record = run(args.topology, args.n_frames, args.device)
    result = record.pop("result")
    if (result.n_frames != args.n_frames
            or result.residue_values.shape[0] != args.n_frames
            or not float(result.totals.min()) > 0.0):
        raise SystemExit(f"trajectory result malformed: {result.n_frames} "
                         f"frames")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
