#!/usr/bin/env python
"""Corpus bench of the port: E. coli-proteome-equivalent residue-level SASA
on every visible card (`--device cuda`; `cuda:N` for one).

    python -m rustsasa_tpu_torch.bench [--device cuda|cpu]

The port's counterpart of `bench.py`, with its protocol: a corpus of the
88 FreeSASA test structures replicated (as symlinks, so every parse does
real I/O) until it holds >= 4,400 structures AND >= 10.7M atoms, the
smallest first (the AlphaFold E. coli proteome's size profile); one warm
pass, then five timed passes of `process_directory` at residue level
with JSON output, each on an engine of its own; the median is the metric.
Then the FreeSASA quality gate (`scripts/quality_gate.py`) on the same
device.  The kernels' first build is timed apart (`build_s`), and so is
the first launch of each production chunk shape before the warm pass
(`warm_shapes_s`, `BatchedSasaEngine.warm_shapes`).

Prints exactly one JSON line: bench.py's keys (`value` the median pass
in seconds, `vs_baseline` against RustSASA's 5.237 s on an 8-core M3),
plus the package, backend, device, the card's `nvidia-smi` name and
power limit, the five pass times in order, their median and spread
((max - min) / median), the count kernel's launches in each pass, the
banded chunk's dequant and cull kernels' launches in each pass
(`band_launches`: `dequant_boxes`, `band_jlist`), the chunks each route
took in each pass (`routes`) and each device entry (`entries`).
`RUSTSASA_TPU_PROFILE=1` logs each pass's host stage split to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(REPO, "tests", "data", "freesasa_pdbs")
WORK_DIR = os.path.join(REPO, "build", "rustsasa_tpu_torch", "bench")
BASELINE_SECONDS = 5.237  # reference: README.md:155, paper/paper.md:41
TARGET_FILES = 4400
TARGET_ATOMS = 10_700_000
PASSES = 5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_corpus(corpus_dir):
    """bench.py's corpus rule: cycle the largest ascending-size prefix of
    the structures in SOURCE_DIR whose mean atom count stays at or under
    the proteome's (TARGET_ATOMS / TARGET_FILES), as symlinks, until both
    targets are met.  Returns (files, atoms, distinct structures)."""
    from .io.read import read_structure

    files = sorted(
        os.path.join(SOURCE_DIR, f) for f in os.listdir(SOURCE_DIR)
        if f.endswith((".pdb", ".cif", ".pdb.gz", ".cif.gz"))
    )
    sizes = {f: read_structure(f).n_atoms() for f in files}
    target_mean = TARGET_ATOMS / TARGET_FILES
    prefix, total = [], 0
    for f in sorted(files, key=lambda f: sizes[f]):
        if prefix and (total + sizes[f]) / (len(prefix) + 1) > target_mean:
            break
        prefix.append(f)
        total += sizes[f]
    if os.path.isdir(corpus_dir):
        shutil.rmtree(corpus_dir)
    os.makedirs(corpus_dir)
    count = n_atoms = 0
    while count < TARGET_FILES or n_atoms < TARGET_ATOMS:
        f = prefix[count % len(prefix)]
        # "1jcd.pdb.gz" -> "1jcd_00005.pdb.gz": every copy gets its own
        # output file (bench.py's "1jcd.pdb_00005.gz" copies all write
        # 1jcd.json).
        base = os.path.basename(f)
        stem = base.split(".")[0]
        os.symlink(f, os.path.join(
            corpus_dir, f"{stem}_{count:05d}{base[len(stem):]}"
        ))
        n_atoms += sizes[f]
        count += 1
    return count, n_atoms, len(prefix)


def run(device="cuda", work_dir=WORK_DIR, say=log) -> dict:
    """The bench on `device`, its corpus and outputs under `work_dir`;
    returns its JSON record.  `say` takes each log line.  Raises nothing
    for failed files: the record counts them (`n_ok`, `n_errors`) and the
    caller decides."""
    import torch

    from .api import SASAOptions
    from .batch import process_directory
    from .levels import Level
    from .ops import _kernels
    from .ops.engine import BatchedSasaEngine, SasaParams
    from .utils import stagestats
    from .utils.card import nvidia_smi

    dev = torch.device(device)
    card = nvidia_smi() if dev.type == "cuda" else None
    build_s = 0.0
    if dev.type == "cuda":
        t0 = time.perf_counter()
        _kernels.build()
        build_s = time.perf_counter() - t0
        say(f"kernels built in {build_s:.1f}s on "
            f"{torch.cuda.get_device_name(dev)}")
    corpus = os.path.join(work_dir, "corpus")
    n_files, n_atoms, n_distinct = build_corpus(corpus)
    say(f"corpus: {n_files} structures, {n_atoms} atoms ({n_distinct} "
        f"distinct) at {corpus}")

    # Each production chunk shape's first launch (module loads, the
    # allocator's growth) before the warm pass, as bench.py does
    # (engine.warm_shapes); 0.0 on the CPU.
    warm_shapes_s = BatchedSasaEngine(SasaParams(), device=dev).warm_shapes()
    say(f"warm_shapes took {warm_shapes_s:.3f}s")

    options = SASAOptions(level=Level.RESIDUE, device=device)
    times, launches, chunks, entries, n_ok = [], [], [], [], []
    band_launches, routes = [], []
    n_errors = 0
    backend = None
    warm_s = None
    for i in range(PASSES + 1):
        name = "warm" if i == 0 else f"run {i - 1}"
        out_dir = os.path.join(work_dir, "out")
        shutil.rmtree(out_dir, ignore_errors=True)
        engine = BatchedSasaEngine(SasaParams(), device=dev)
        backend = engine.backend
        _kernels.reset_launch_counts()
        stagestats.reset()
        t0 = time.perf_counter()
        report = process_directory(corpus, out_dir, options, "json",
                                   progress=False, engine=engine)
        elapsed = time.perf_counter() - t0
        n_launch = _kernels.launch_counts["fused_count"]
        say(f"{name}: {report.n_ok}/{report.n_files} files in "
            f"{elapsed:.3f}s ({n_atoms / elapsed / 1e6:.3f} Matoms/s); "
            f"{engine.chunks_dispatched} chunks, {n_launch} fused_count "
            f"launches; errors {len(report.errors)}")
        for e in report.errors[:5]:
            say(f"  error: {e}")
        if stagestats.enabled:
            say(stagestats.report(elapsed))
        if i == 0:
            warm_s = elapsed
            continue
        times.append(elapsed)
        launches.append(n_launch)
        chunks.append(engine.chunks_dispatched)
        entries.append(list(engine.routes.entries))
        band_launches.append({k: _kernels.launch_counts[k]
                              for k in ("dequant_boxes", "band_jlist")})
        routes.append(dict(engine.routes.counts))
        n_ok.append(report.n_ok)
        n_errors += len(report.errors)
    median = statistics.median(times)
    say(f"median {median:.3f}s over {PASSES} passes {times}")

    from .scripts import quality_gate

    gate = quality_gate.run_gate(device)
    quality_gate.write_artifact(gate)
    for row in gate["rows"]:
        say(f"quality gate [{row['depth']:17s}]: rmse={row['rmse']} "
            f"n={row['n']} {row['n_ok']}/{row['n_files']} files "
            f"pass={row['pass']}")

    return {
        "metric": "ecoli_proteome_equiv_residue_sasa_wall",
        "value": median,
        "unit": "s",
        "vs_baseline": BASELINE_SECONDS / median,
        "runs": sorted(times),
        "best": min(times),
        "best_vs_baseline": BASELINE_SECONDS / min(times),
        "warmup_s": warm_s,
        "quality_pass": bool(gate["pass"]),
        "quality_residue_rmse": gate["rmse"],
        "package": "rustsasa_tpu_torch",
        "backend": backend,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "gpu_name": card[0] if card else None,
        "power_limit": card[1] if card else None,
        "build_s": build_s,
        "warm_shapes_s": warm_shapes_s,
        "n_files": n_files,
        "n_atoms": n_atoms,
        "n_ok": n_ok,
        "n_errors": n_errors,
        "passes": times,
        "median": median,
        "spread": (max(times) - min(times)) / median,
        "fused_count_launches": launches,
        "chunks": chunks,
        "band_launches": band_launches,
        "routes": routes,
        "entries": entries,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
