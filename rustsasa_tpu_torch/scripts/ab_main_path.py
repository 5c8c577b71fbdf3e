"""The main path's figures on two checkouts, timed in turns on one card.

    python -m rustsasa_tpu_torch.scripts.ab_main_path PARENT_ROOT \\
        [--out FILE]

Compares a change to the banded chunk's device stages with its parent in
one call on one card: the host's speed moves the corpus figures between
calls (1.73x), so the trees take turns (A = PARENT_ROOT, B = the tree
holding this script) in the order ORDER.  Each turn is one process,
started in its tree's root and importing that tree's package, that
measures:

  stages_05m  the q13 check chunk (the bench corpus's first structures up
              to 524,288 slots, as chip_smoke.py's phase 2), through the
              functions every tree has: the dequant (`dequant_q13`: wire
              -> planes), the banded cull (`build_jlist_banded` without
              boxes: planes -> j-lists, the boxes' reductions included),
              kernel 1 (`fused_counts`), and the main path's call
              (`fused_sasa_q13_banded`); each the mean of REPS calls
              between two CUDA events after a warm call;
  stages_2m   r4_atombox's q16 chunk (the first 900 files, 2,097,152
              slots, w = 32), the same way;
  host_cull   `profile_fused`'s kernel 1 (and the areas) on the first
              512 files' host-cull f32 wire, best of three;
  single_file `benches/single_protein.py` (example.cif, warm, median of
              25 calls of the CLI's single-file route);
  trajectory  `benches/md_trajectory.py`'s timed pass (example.cif x
              2,500 frames);
  device2     `profile_native_pipeline`'s warm engine call over 1,024
              strided corpus files (with load and emit);
  bench       `python -m rustsasa_tpu_torch.bench`'s five passes, median
              and spread (and its quality gate).

Prints each turn's JSON line and a summary beside the card's name and
power limit, and writes them to --out.  Needs a CUDA device and the bench corpus (built under
each tree's build/ab_main_path/ when absent).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ORDER = "ABBAABBA"
REPS = 10
CHECK_SLOTS = 524_288

# Run in a tree's root with its package: argv = work_dir, reps, slots.
TURN_SCRIPT = r'''
import json, os, sys
import torch
from rustsasa_tpu_torch import bench
from rustsasa_tpu_torch.benches import md_trajectory, single_protein
from rustsasa_tpu_torch.ops import engine, fused_kernel as fk
from rustsasa_tpu_torch.scripts import _study, profile_fused
from rustsasa_tpu_torch.scripts import profile_native_pipeline, r4_atombox

work, reps, slots = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda", 0)
sphere = engine._sphere_device(100, dev)


def say(msg):
    print(msg, file=sys.stderr, flush=True)


def ms(fn):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def stages(wire, arrays, tmeta, w):
    deq_ms, (planes, qvalid) = ms(
        lambda: getattr(fk, "dequant_" + wire)(*arrays))
    cull_ms, jlist = ms(
        lambda: fk.build_jlist_banded(planes, qvalid, tmeta, w=w))
    kernel_ms, _ = ms(lambda: fk.fused_counts(planes, jlist, sphere))
    chain_ms, _ = ms(lambda: getattr(fk, "fused_sasa_%s_banded" % wire)(
        *arrays, tmeta, sphere, n_points=100, w=w))
    return {"slots": planes.shape[1], "w": w, "dequant_ms": deq_ms,
            "cull_ms": cull_ms, "kernel_ms": kernel_ms,
            "chain_ms": chain_ms}


corpus = os.path.join(work, "corpus")
bench.build_corpus(corpus)
out = {"tree": os.getcwd(), **_study.where(dev)}

triples = _study.load_corpus(corpus, slots=slots)
wa, wb, pal, tp, tm, _ = fk.pack_structures_q13(triples, 1.4)
max_nt = max(-(-t[0].shape[0] // 128) for t in triples)
w = next(b for b in fk.W_BUCKETS if b >= max_nt)
wire = fk.to_device((wa, wb, pal, tp, tm), dev)
out["stages_05m"] = stages("q13", wire[:4], wire[4], w)
say("stages_05m %s" % out["stages_05m"])
planes4, tparams, tmeta, _real, _atoms, _n = r4_atombox.load_chunk(corpus, dev)
out["stages_2m"] = stages("q16", (planes4, tparams), tmeta, r4_atombox.W)
say("stages_2m %s" % out["stages_2m"])
del wire, planes4, tparams, tmeta
fused = profile_fused.run(corpus, device="cuda")
out["host_cull"] = {"ms": fused["ms"], "atoms": fused["atoms"]}
say("host_cull %s" % out["host_cull"])

single = single_protein.run(device="cuda")
out["single_file"] = {"median_ms": single["value"],
                      "best_ms": single["best_ms"],
                      "stages_median_ms": single["stages_median_ms"]}
traj = md_trajectory.run(device="cuda", say=say)
out["trajectory"] = {"s": traj["value"], "warm_s": traj["warmup_s"]}
pnp = profile_native_pipeline.run(corpus, device="cuda",
                                  out_dir=os.path.join(work, "pnp_out"))
out["device2"] = {k: pnp[k] for k in ("files", "atoms", "load_s",
                                      "device2_s", "emit_s")}
record = bench.run("cuda", work, say=say)
out["bench"] = {k: record.get(k) for k in (
    "median", "spread", "passes", "quality_pass", "chunks",
    "fused_count_launches", "band_launches", "routes")}
print(json.dumps(out), flush=True)
'''


def turn(root: str) -> dict:
    """One turn in `root`: the turn script's JSON record."""
    work = os.path.join(root, "build", "ab_main_path")
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, "-c", TURN_SCRIPT, work, str(REPS),
         str(CHECK_SLOTS)], cwd=root, env=env, stdout=subprocess.PIPE,
        text=True, timeout=1800, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


FIGURES = (
    ("stages_05m", "dequant_ms"), ("stages_05m", "cull_ms"),
    ("stages_05m", "kernel_ms"), ("stages_05m", "chain_ms"),
    ("stages_2m", "dequant_ms"), ("stages_2m", "cull_ms"),
    ("stages_2m", "kernel_ms"), ("stages_2m", "chain_ms"),
    ("host_cull", "ms"),
    ("single_file", "median_ms"), ("single_file", "best_ms"),
    ("trajectory", "s"), ("device2", "device2_s"), ("device2", "load_s"),
    ("device2", "emit_s"), ("bench", "median"), ("bench", "spread"),
)


def summary(turns) -> list[str]:
    """One line a figure: each tree's values in turn order, and their
    medians."""
    out = []
    for group, key in FIGURES:
        by = {"A": [], "B": []}
        for tag, rec in turns:
            by[tag].append(rec[group][key])
        out.append(
            f"{group}.{key}: A {by['A']} B {by['B']}; medians "
            f"{statistics.median(by['A']):.6g} -> "
            f"{statistics.median(by['B']):.6g}")
    rec = turns[0][1]
    out.append(f"on {rec['gpu_name']}, {rec['power_limit']}, "
               f"{rec['cpu_count']} host cores")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("parent", help="root of the tree to compare with (A)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    roots = {"A": os.path.abspath(args.parent), "B": ROOT}
    turns = []
    for tag in ORDER:
        rec = turn(roots[tag])
        print(f"{tag} {json.dumps(rec)}", flush=True)
        turns.append((tag, rec))
    lines = summary(turns)
    for line in lines:
        print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({"turns": turns, "summary": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
