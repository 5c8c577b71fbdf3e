#!/usr/bin/env python
"""Multi-process scaling curve of the port's distributed directory batch.

    python -m rustsasa_tpu_torch.scripts.scaling_curve [out.json]
        [--device cuda|cpu]

The counterpart of `scripts/scaling_curve.py`, with its corpus rule: 66
files cycled from the first 11 FreeSASA structures (11 is coprime with 2
and 4, so round-robin shards cycle every structure through every rank),
run through `parallel.worker` (`process_directory_distributed`, Gloo
metrics all-reduce) at 1, 2 and 4 ranks.  On "cuda" every rank takes
card rank mod the visible cards: on a one-card host all ranks share
cuda:0.  Each configuration must report identical global metrics on
every rank, cover every input once, and write the bytes the one-rank run
writes.  Records structures/s (66 over the slowest rank's own shard
time, start-up and the final all-reduce excluded), every rank's shard
time, the end-to-end wall time, the host's
`os.cpu_count()` and the card's `nvidia-smi` name and power limit; the
kernels are built first, apart (`build_s`).  The artifact goes to
build/rustsasa_tpu_torch/scaling_curve.json by default.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import sys

from ..parallel.worker import ROOT, run_workers

SOURCE_DIR = os.path.join(ROOT, "tests", "data", "freesasa_pdbs")
WORK_DIR = os.path.join(ROOT, "build", "rustsasa_tpu_torch", "scaling")
N_FILES = 66
N_SOURCES = 11
RANKS = (1, 2, 4)


def build_corpus(corpus_dir: str) -> int:
    """scripts/scaling_curve.py's corpus: N_FILES decompressed copies
    named <count>_<stem>, cycling the first N_SOURCES structures."""
    if os.path.isdir(corpus_dir):
        shutil.rmtree(corpus_dir)
    os.makedirs(corpus_dir)
    sources = sorted(f for f in os.listdir(SOURCE_DIR)
                     if f.endswith((".pdb", ".pdb.gz")))[:N_SOURCES]
    for count in range(N_FILES):
        name = sources[count % len(sources)]
        src = os.path.join(SOURCE_DIR, name)
        stem = name[:-3] if name.endswith(".gz") else name
        dst = os.path.join(corpus_dir, f"{count:04d}_{stem}")
        if name.endswith(".gz"):
            with gzip.open(src, "rb") as f, open(dst, "wb") as g:
                g.write(f.read())
        else:
            shutil.copy(src, dst)
    return N_FILES


def read_outputs(out_dir: str) -> dict:
    """{file name: bytes} of every file in `out_dir`."""
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = f.read()
    return out


def run(device: str = "cuda") -> dict:
    """The curve on `device`; raises if a configuration's reports differ,
    miss an input or write other bytes than one rank."""
    import time

    from ..ops import _kernels
    from ..utils.card import nvidia_smi

    build_s = 0.0
    if device != "cpu":
        # Built once here, so no rank's time holds nvcc.
        t0 = time.perf_counter()
        _kernels.build()
        build_s = time.perf_counter() - t0
    corpus = os.path.join(WORK_DIR, "corpus")
    n = build_corpus(corpus)
    rows, first = [], None
    for world in RANKS:
        out_dir = os.path.join(WORK_DIR, f"out_{world}")
        shutil.rmtree(out_dir, ignore_errors=True)
        reports, wall = run_workers(world, corpus, out_dir,
                                    os.path.join(WORK_DIR, "reports"),
                                    device=device)
        shared = [(r["n_files"], r["n_ok"], r["n_errors"], r["total_area"])
                  for r in reports]
        if len(set(shared)) != 1 or shared[0][:3] != (n, n, 0):
            raise AssertionError(f"{world} ranks: reports {shared}")
        outputs = read_outputs(out_dir)
        if first is None:
            first = outputs
        if len(outputs) != n or outputs != first:
            raise AssertionError(f"{world} ranks: {len(outputs)} outputs, "
                                 "or bytes other than one rank's")
        slowest = max(r["shard_s"] for r in reports)
        rows.append({
            "ranks": world,
            "devices": [r["device"] for r in reports],
            "end_to_end_wall_s": wall,
            "processing_wall_s": max(r["elapsed_s"] for r in reports),
            "rank_shard_s": [r["shard_s"] for r in reports],
            "structures_per_s": n / slowest,
            "fused_count_launches": sum(r["launches"]["fused_count"]
                                        for r in reports),
            "global_n_ok": reports[0]["n_ok"],
            "global_total_area": reports[0]["total_area"],
        })
    card = nvidia_smi() if device != "cpu" else None
    return {
        "corpus_files": n,
        "host_cores": os.cpu_count(),
        "device": device,
        "gpu_name": card[0] if card else None,
        "power_limit": card[1] if card else None,
        "build_s": build_s,
        "rows": rows,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rustsasa_tpu_torch.scripts.scaling_curve")
    parser.add_argument("out", nargs="?",
                        default=os.path.join(WORK_DIR, "scaling_curve.json"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    result = run(args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
