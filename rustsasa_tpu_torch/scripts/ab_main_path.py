"""The main path's figures on two checkouts, timed in turns on one card.

    python -m rustsasa_tpu_torch.scripts.ab_main_path PARENT_ROOT \\
        [--turn main|studies|list_1jz8] [--out FILE]

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

With --turn list_1jz8 each turn measures the list path's neighbor phase
on 1jz8 instead (LIST_TURN_SCRIPT, N = 32,768 at its first K), through
functions every tree has:

  phase       `neighbors.neighbor_records` (the binning and ordering, and
              the neighbor kernel), the mean of REPS calls in a CUDA graph
              and back to back between two CUDA events, after a warm call;
  order       the phase's binning and ordering alone, the same two ways:
              `_kernels.cell_keys`, and where the tree's binning kernel
              leaves the order to torch (it returns keys, max_r and h
              only), the stable sort and the two index_selects after it;
  batches     the same in a CUDA graph on two seeded batches of small
              structures (B x N = 40 x 96 and 511 x 8, ~30 % padding);
  kernel      `_kernels.neighbor_cells` alone on the tree's own inputs
              (keys from `neighbors.cell_grid` and a stable sort, with
              the sorted gather where the tree's launcher takes it), the
              same two ways;
  sasa        `neighbors.records_sasa` on the phase's records at P = 104
              (100 points), back to back, and the SASA's sum, which the
              trees must share.

With --turn studies each turn times the count-kernel studies rebuilt on
kernel 1's layout (STUDY_TURN_SCRIPT), through functions every tree
has:

  k1_05m      kernel 1 (`fused_counts`) on the q13 check chunk, as
              stages_05m.kernel_ms;
  sat_05m, sat_2m, micro_05m, micro_2m, reach_05m, reach_2m
              `r4_saturation.run`, `r4_microkernel.run` and
              `r3_kernel_variants.run` (kernels only, their best-of ms a
              variant, kernel 1 included) on the host-cull f32 chunk of
              the <= 32-tile corpus structures at 524,288 and 2,097,152
              slots (chip_smoke.py phases 8-9);
  pair_05m, pair_2m
              `r5_pair64.run` (prod, nibble and pair64) on the banded q16
              chunk (w = 32) of the same structures.

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


# Run in a tree's root with its package: argv = reps.
LIST_TURN_SCRIPT = r'''
import inspect, json, os, sys
import numpy as np
import torch
from rustsasa_tpu_torch.ops import _kernels, engine, neighbors
from rustsasa_tpu_torch.scripts import _study, layout_probe

reps = int(sys.argv[1])
dev = torch.device("cuda", 0)
probe = 1.4


def timed(fn):
    """(ms in a CUDA graph, ms a call back to back) of fn()."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    in_graph = start.elapsed_time(stop) / reps
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return in_graph, start.elapsed_time(stop) / reps


coords, radii, gids = _study.select(layout_probe.LIST_STRUCTURE)
n_pad = neighbors._round_bucket(coords.shape[0], neighbors._N_BUCKETS)
packed, gid = (torch.from_numpy(a).to(dev) for a in
               engine._pack(n_pad, [(coords, radii, gids)]))
k = neighbors._initial_k(n_pad)
m = gid.numel()
grid = neighbors.cell_grid(packed, gid, probe)
sorted_keys, perm = torch.sort(grid.keys, stable=True)
args = [packed, gid, grid.max_r, grid.keys, sorted_keys, perm]
if "sorted_packed" in inspect.signature(_kernels.neighbor_cells).parameters:
    args += [packed.reshape(m, 4).index_select(0, perm),
             gid.reshape(m).index_select(0, perm)]
phase_graph, phase_call = timed(
    lambda: neighbors.neighbor_records(packed, gid, probe=probe, k=k))


def order(packed=packed, gid=gid):
    got = _kernels.cell_keys(packed, gid, probe)
    if len(got) > 3:
        return got
    n = gid.numel()
    sorted_keys, perm = torch.sort(got[0], stable=True)
    return (sorted_keys, packed.reshape(n, 4).index_select(0, perm),
            gid.reshape(n).index_select(0, perm))


order_graph, order_call = timed(order)
batches = {}
for b, n in ((40, 96), (511, 8)):
    rng = np.random.default_rng(b)
    small = np.zeros((b, n, 4), np.float32)
    small[..., :3] = rng.uniform(-15.0, 15.0, (b, n, 3))
    small[..., 3] = rng.choice([1.4, 1.6, 1.8, 2.0], (b, n))
    small_gid = np.tile(np.arange(n, dtype=np.int32), (b, 1))
    small_gid[rng.random((b, n)) < 0.3] = -1
    batch = tuple(torch.from_numpy(a).to(dev) for a in (small, small_gid))
    batches["b%d_graph_ms" % b] = timed(lambda: order(*batch))[0]
kernel_graph, kernel_call = timed(
    lambda: _kernels.neighbor_cells(*args, probe=probe, k=k))
records = neighbors.neighbor_records(packed, gid, probe=probe, k=k)
sphere = engine._sphere_device(100, dev)


def sasa():
    return neighbors.records_sasa(records, packed, gid, sphere, probe=probe,
                                  n_points=100)


sasa()
torch.cuda.synchronize()
start = torch.cuda.Event(enable_timing=True)
stop = torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(reps):
    out = sasa()
stop.record()
torch.cuda.synchronize()
print(json.dumps({
    "tree": os.getcwd(), **_study.where(dev),
    "phase": {"graph_ms": phase_graph, "call_ms": phase_call},
    "order": {"graph_ms": order_graph, "call_ms": order_call},
    "batches": batches,
    "kernel": {"graph_ms": kernel_graph, "call_ms": kernel_call},
    "sasa": {"ms": start.elapsed_time(stop) / reps,
             "sum": float(out.double().sum()), "points": sphere.shape[0],
             "max_count": int(records[2]), "k": k},
}), flush=True)
'''
LIST_FIGURES = (
    ("phase", "graph_ms"), ("phase", "call_ms"), ("order", "graph_ms"),
    ("order", "call_ms"), ("batches", "b40_graph_ms"),
    ("batches", "b511_graph_ms"), ("kernel", "graph_ms"),
    ("kernel", "call_ms"), ("sasa", "ms"), ("sasa", "sum"),
)


# Run in a tree's root with its package: argv = work_dir, reps, slots.
STUDY_TURN_SCRIPT = r'''
import json, os, sys
import torch
from rustsasa_tpu_torch import bench
from rustsasa_tpu_torch.ops import engine, fused_kernel as fk
from rustsasa_tpu_torch.scripts import _study, r4_microkernel, r4_saturation
from rustsasa_tpu_torch.scripts import r3_kernel_variants, r5_pair64

work, reps, slots = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda", 0)
sphere = engine._sphere_device(100, dev)
corpus = os.path.join(work, "corpus")
bench.build_corpus(corpus)
out = {"tree": os.getcwd(), **_study.where(dev)}

triples = _study.load_corpus(corpus, slots=slots)
wa, wb, pal, tp, tm, _ = fk.pack_structures_q13(triples, 1.4)
max_nt = max(-(-t[0].shape[0] // 128) for t in triples)
w = next(b for b in fk.W_BUCKETS if b >= max_nt)
wire = fk.to_device((wa, wb, pal, tp, tm), dev)
planes, qvalid = fk.dequant_q13(*wire[:4])
jlist = fk.build_jlist_banded(planes, qvalid, wire[4], w=w)
fk.fused_counts(planes, jlist, sphere)
torch.cuda.synchronize()
start = torch.cuda.Event(enable_timing=True)
stop = torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(reps):
    fk.fused_counts(planes, jlist, sphere)
stop.record()
torch.cuda.synchronize()
out["k1_05m"] = {"ms": start.elapsed_time(stop) / reps}
del wire, planes, qvalid, jlist
for tag, n in (("05m", slots), ("2m", _study.M_PAD)):
    chunk = _study.load_corpus(corpus, slots=n, max_tiles=32)
    for name, study in (("sat", r4_saturation), ("micro", r4_microkernel),
                        ("reach", r3_kernel_variants), ("pair", r5_pair64)):
        res = study.run(chunk, dev, slots=n)
        out[name + "_" + tag] = {k: v["ms"] for k, v in res["variants"].items()}
        print("%s_%s %s" % (name, tag, out[name + "_" + tag]), file=sys.stderr,
              flush=True)
print(json.dumps(out), flush=True)
'''
STUDY_FIGURES = (
    ("k1_05m", "ms"),
    *((f"sat_{tag}", v) for tag in ("05m", "2m")
      for v in ("prod", "sat1", "sat2", "sat4")),
    *((f"micro_{tag}", v) for tag in ("05m", "2m")
      for v in ("k1", "prod", "split2", "g16", "g24", "nosmem")),
    *((f"reach_{tag}", v) for tag in ("05m", "2m")
      for v in ("k1", "base", "nogroupcond", "jskip", "group4", "nocond",
                "bf16", "bf16p")),
    *((f"pair_{tag}", v) for tag in ("05m", "2m")
      for v in ("prod", "nibble", "pair64")),
)


def turn(root: str, kind: str = "main") -> dict:
    """One turn of `kind` in `root`: its turn script's JSON record."""
    work = os.path.join(root, "build", "ab_main_path")
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=root)
    argv = {"main": [TURN_SCRIPT, work, str(REPS), str(CHECK_SLOTS)],
            "studies": [STUDY_TURN_SCRIPT, work, str(REPS), str(CHECK_SLOTS)],
            "list_1jz8": [LIST_TURN_SCRIPT, str(REPS)]}[kind]
    proc = subprocess.run(
        [sys.executable, "-c", *argv], cwd=root, env=env,
        stdout=subprocess.PIPE, text=True, timeout=1800, check=True)
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


def summary(turns, figures=FIGURES) -> list[str]:
    """One line a figure of `figures`: each tree's values in turn order,
    and their medians."""
    out = []
    for group, key in figures:
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
    p.add_argument("--turn", choices=("main", "studies", "list_1jz8"),
                   default="main")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    roots = {"A": os.path.abspath(args.parent), "B": ROOT}
    turns = []
    for tag in ORDER:
        rec = turn(roots[tag], args.turn)
        print(f"{tag} {json.dumps(rec)}", flush=True)
        turns.append((tag, rec))
    lines = summary(turns, {"main": FIGURES, "studies": STUDY_FIGURES,
                            "list_1jz8": LIST_FIGURES}[args.turn])
    for line in lines:
        print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({"turns": turns, "summary": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
