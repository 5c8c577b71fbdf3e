#!/usr/bin/env python
"""Single-worker corpus bench of the port (reference: paper/paper.md:43,
26.0 s).

    python -m rustsasa_tpu_torch.benches.single_worker_proteome \\
        [--device cuda|cpu]

The reference's single-threaded row pins the per-core efficiency of its
CPU pipeline (rayon pool of 1).  The analog here: ONE host worker thread
for parse/select/emit over the port bench's corpus (`bench.build_corpus`,
>= 4,400 files and >= 10.7M atoms); the device is the same either way.
One warm pass, one timed pass, beside the card's `nvidia-smi` name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

REFERENCE_S = 26.0


def run(device="cuda") -> dict:
    from ..api import SASAOptions
    from ..batch import process_directory
    from ..bench import WORK_DIR, build_corpus
    from ..levels import Level
    from ..utils.card import nvidia_smi

    work = os.path.join(WORK_DIR, "single_worker")
    corpus = os.path.join(work, "corpus")
    n_files, n_atoms, _ = build_corpus(corpus)
    options = SASAOptions(level=Level.RESIDUE, device=device)
    for name in ("warm", "timed"):
        out = os.path.join(work, "out")
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        report = process_directory(corpus, out, options, "json",
                                   workers=1, progress=False)
        elapsed = time.perf_counter() - t0
    card = nvidia_smi() if str(device).startswith("cuda") else None
    where = f"{card[0]}, {card[1]}" if card else str(device)
    print(f"single-worker: {report.n_ok}/{report.n_files} files, {n_atoms} "
          f"atoms in {elapsed:.3f}s on {where}, errors={len(report.errors)}",
          file=sys.stderr, flush=True)
    return {
        "metric": "ecoli_proteome_equiv_single_worker_wall",
        "value": elapsed,
        "unit": "s",
        "reference_s": REFERENCE_S,
        "vs_reference": REFERENCE_S / elapsed,
        "n_files": n_files,
        "n_ok": report.n_ok,
        "device": str(device),
        "gpu_name": card[0] if card else None,
        "power_limit": card[1] if card else None,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
