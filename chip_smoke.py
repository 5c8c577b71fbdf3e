#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `rustsasa_tpu_torch/ops/csrc/` and
runs sixteen phases, each of which must pass:

  1. build: nvcc for sm_90a, one process per kernel source, all started
     together, with the compiler's register/spill report;
  2. the banded chunk's kernels vs plain: one real q13 chunk of up to
     524,288 slots from the corpus below through dequant_boxes (planes,
     qvalid and boxes bit-equal to the plain dequant and boxes),
     band_jlist (j-lists byte-equal in all 128 columns to the plain
     builder) and the count kernel (counts byte-equal at every real atom
     slot), each kernel and plain version on the same device tensors,
     timed with CUDA events after a warm launch (the two band kernels
     also inside a CUDA graph, their device time without the host's
     enqueue), with their bounds; the count kernel, redesigned, logged
     with its bound on the work the chunk needs (in-reach pairs and
     reach tests, fused_kernel.reach_work) beside the old one on every
     admitted margin and the one at the reach test's SASS, its ptxas
     registers, spills and shared memory, the j-atoms an atom has
     admitted, in reach of some atom of its tile, of 32 atoms, of 4, of
     itself, and streamed (the rows each warp streamed, counted by a
     debug instantiation, equal to the plain model's); the same on
     r4_atombox's 2M banded q16 chunk (counts byte-equal to plain), and
     the count kernel byte-equal to plain on near-tangent pairs and on
     pairs spread past tangency (some skipped by distance, small j-radii
     about the skip's guard) at 100 and 1,000 points;
     then dequant_boxes and band_jlist at
     every band width (16, 24, 32, 64, 127) on the q13 and q16 wires, on
     seeded synthetic structures (3, 100, 700 and up to 16,000 atoms,
     the largest picking the width) with two padding tiles appended,
     bit-equal and byte-equal again, with entries past the chunk's ends
     in the rows' tails;
  3. golden: example.cif per-atom SASA within 25 A^2 of the stored golden
     array (tests/test_golden.py) and the protein total within 1500 of
     20268; a 3-file directory batch gives byte-identical JSON on CUDA
     and on the CPU (plain-torch kernels);
  4. main path: the port's bench (`rustsasa_tpu_torch.bench.run`):
     `process_directory` at residue level, JSON output, on CUDA, over a
     corpus built by bench.py's rule (the 88 FreeSASA test structures
     cycled to >= 4,400 files and >= 10.7M atoms), one warm and five timed
     passes (median and spread), then the quality gate; every file must
     succeed, the gate pass, and the count kernel's launch count in each
     pass equal the chunks the engine dispatched, dequant_boxes' the
     q13, q16 and host-cull q16 chunks, band_jlist's the q13 and q16
     chunks;
  5. the list path's kernels vs plain: the binning and ordering kernels
     (cell_keys) bit-equal to neighbors.cell_order_reference (keys,
     max_r, cell edges from cell_grid; sorted keys, perm, sorted packed
     and sorted gid from a stable torch.sort and its gathers) and the
     neighbor kernel (neighbor_cells.cu) against the plain neighbor phase
     on the seeded cases of `_study.neighbor_cases` (a batch of three
     structures with padding rows and a shared group id, groups of four
     ids, clusters at +-1,000 A, a 4,000 A line, pairs at the cutoff
     within an ulp of d2, the dense ball whose rows overflow K, six
     structures in N = 8) and `_study.order_cases` (a cell of 300 atoms,
     40 structures with padding between their atoms, one with no real
     atom, a +-1e6 A span, 511 structures), one launch of each a case:
     counts, max_count and each row's set of record bit patterns equal,
     the list SASA at 100 points from either byte-equal;
     then 1jz8 (the largest test structure): its records as the list
     path makes them (one neighbor launch a run), the list-occlusion
     kernel and its plain version on them at 100 points, byte-equal, both
     timed, with the tiles' neighbor bounds (min, mean, max) and the
     wrapper's host time a call, byte-equal again at 960 and 50,000
     points (several blocks of points a tile, beyond one wave of CTAs);
     the binning and ordering bit-equal to its plain version on 1jz8,
     the neighbor kernel, cell_keys (binning and ordering), the chain the
     ordering replaced (a stable torch.sort and two index_selects) and
     the whole phase (cell_keys, neighbor_cells) warm, in a CUDA graph
     and as calls back to back, the plain versions
     (cell_order_reference; expansion, top-k, its K-major copies) warm,
     held equal as on the cases, the list SASA at
     P = 104, 960 and 50,000 byte-equal from kernel-made and plain-made
     records, and each kernel's bound (bytes; FP32 operations of the
     pairs its cells visit, f64 ones of the binning; the bytes the
     binning and ordering must move), its share of it, ptxas registers,
     spills and shared memory;
  6. list path: `calculate_sasa_internal(backend="list")` on example.cif
     against the golden array and protein total, and the closed-form cases
     of tests/test_sanity.py at 50,000 points within 0.5 %; the list,
     binning and neighbor kernels must launch once each a batch and the
     count kernel must not;
  7. host-cull wires: `process_directory` over all 88 FreeSASA structures
     on CUDA, with the chunks of each route counted (the three largest
     need the host-cull wires or the list path, one list, one binning
     and one neighbor kernel a list chunk); their JSON is
     byte-identical to the CPU's; a shared-group-id structure through the
     f32 wire equals the CPU result exactly;
  8. count-kernel studies: on a banded q16 chunk of 524,288 slots
     (w = 32) the per-half (pair64) and nibble-list kernels, and on the
     host-cull f32 chunk of the same structures the tile-saturation kernel
     checking every 1, 2 and 4 entries, each byte-equal to its plain
     version (saturation: counts and entries streamed) and equal to the
     count kernel at every real slot; then the studies' run() at
     2,097,152 slots, kernels only, timed against the count kernel, whose
     launches are the three kernels' launch counts; each kernel's bound
     on the work its inputs need (kernel 1's: fused_kernel.reach_work of
     its chunk) beside the old one on every admitted margin; the
     saturation, nibble and pair64 kernels (kernel 1's layout, 4 CTAs a
     tile) with their ratio to the count kernel, share of that bound,
     ptxas registers and spills; nibble's reach chunks a live entry
     (packed, four groups a chunk) and pair64's live entries and reach
     chunks a CTA (a half's mask each) against the count kernel's;
  9. count-kernel studies II: on the host-cull f32 chunk of phase 8's
     structures the loop micro-variants (micro_count: prod, split2, g16,
     g24, nosmem) and the reach-test kernel (reach_count: base,
     nogroupcond, jskip, group4, nocond, bf16, bf16p), on their banded q16
     chunk the max-plus kernel (maxplus_count); each byte-equal to its
     plain version for every variant (reach_count: counts and j-rows
     executed), the f32 variants equal to the count kernel at every real
     slot, bf16, bf16p and max-plus with their count difference reported;
     every reach variant also on the buried lattice block; then the three
     studies' run() at 2,097,152 slots, kernels only, whose launches are
     the three kernels' launch counts; the bounds recounted as in phase 8
     (micro_count and reach_count, on kernel 1's layout: each variant's
     ratio to the count kernel and share of that bound, nosmem's of its
     own work; prod's and base's ptxas registers and spills, and
     reach_count's rule kernel timed alone);
 10. kernel experiments: the 22 variants of scripts/kernel_experiments.py
     on its synthetic data (64 tiles x 1,408 resident j-rows), on its ones
     and on seeded random j-data, each against its plain version:
     byte-equal sums and executed groups (the DEFAULT variants, on the
     tensor cores, within kernel_experiments.default_bound); then
     kernel_experiments.run() at the script's 512 tiles, whose launches
     are the four sources' (ke_stream, ke_maxplus, ke_bf16, ke_mxu)
     launch counts;
 11. CLI: `python -m rustsasa_tpu_torch.cli` in a subprocess on
     example.cif at residue level with --device cuda and --device cpu
     (every value within 1e-3; whether the files are byte-equal is
     printed), in directory mode over the 88 FreeSASA files, and with -T
     on a 16-frame DCD; each run's wall time and launches (a binning and
     a neighbor kernel for each list kernel; all three launch in
     directory mode);
 12. trajectory: `compute_trajectory_sasa` over example.cif x 2,500
     jittered frames (benches/md_trajectory.py's workload), a warm and a
     timed pass; frames 0, 1,250 and 2,499 byte-equal to
     `calculate_sasa_internal` of the same frame on the card, frame 0
     within 1e-3 of the CPU's plain path;
 13. quality gate: `scripts/quality_gate.run_gate` on the card, all four
     depths and the occupancy row, 88/88 files and a pass in every row;
     the count and list kernels must launch, a binning and a neighbor
     kernel for each list kernel;
 14. scale-out, on the one card: phase 4's corpus through an engine on
     two streams of it (`devices=[cuda:0, cuda:0]`; a warm and a timed
     pass), byte-equal to phase 4's last pass, every entry dispatching
     and the entries' chunks equal to the count kernel's launches; two
     `parallel.worker` ranks on Gloo over the same corpus, identical
     reports, every file once and byte-equal; the sharded list step
     (`parallel.mesh`) over two streams on the largest even batch of
     FreeSASA structures sharing an N bucket, re-run while its max count
     exceeds K, byte-equal to `_sasa_batched` on the whole batch with its
     total equal to that batch's sum and one list, one binning and one
     neighbor kernel a shard; and `graft_entry.dryrun_multichip` over the two entries
     (one of each a shard again).  The kernel
     records carry these paths' launches (`scale_out_launches`);
 15. profilers and studies: the reference's last scripts through their
     ports' run() at the scripts' sizes on "cuda" -
     profile_native_pipeline and profile_pipeline (the corpus pass's host
     and device stages, each alone, on 1,024 files), profile_fused
     (kernel 1 alone on 512 files, with its FP32 instruction rate at
     the work the inputs need and its share of that bound),
     micro_bench, r4_atombox (900 files at 2,097,152 slots: the two
     rows' j-lists and counts byte-equal), r5_qwire (the q12 wire's r_eff
     bit-equal to radii + probe, its count deltas to q16) and the NumPy
     cull studies r4_cull_granularity and r5_spherecull; each figure
     beside the card's name and power limit; then on a chunk of up to
     524,288 slots kernel 1 byte-equal to its plain version on q12 planes
     and on atombox j-lists, with its bound on each (recounted and the
     old).  The main path's three kernels' records
     carry these paths' launches (`profilers_launches`);
 16. tools: `BatchedSasaEngine.warm_shapes` on its nine production
     (M, w) shapes, each of dequant_boxes, band_jlist and fused_count
     launched once a shape; scripts/r3_link_floor.py (the dispatch floor,
     pageable and pinned copy rates both ways, the 2,622-atom protein end
     to end); scripts/r3_split.py on the corpus's first 900 files (the
     host-cull f32 and banded q13 routes split into copies, kernels and
     readback, their end-to-end counts byte-equal to the kernels-alone
     run and the q13 counts to the engine's, then a whole bench pass with
     every chunk's device work between CUDA events: the device's idle
     share); `precompile_fused --quick` in a process of its own (each
     production shape's first launch, all nine shapes warm through a
     thread a shape and serially, then one row a wire and band width;
     its launches counted from 0 in that process, each call's adding up
     to its totals).  The main path's three kernels' records carry these
     paths' launches (`tools_launches`).

Phases 2, 5, 9 and 10 log the kernels redesigned for this card
(fused_count; list_occlusion and neighbor_cells; maxplus_count; ke_mxu's
mxu_dots_def,
ke_maxplus's six variants, ke_bf16's two and ke_stream's nobig and
noscalar) with their
bound, share of it, FP32 instruction rate, ptxas registers and spills
and shared memory.  Prints the card's name and
power limit, one JSON line with the fourteen kernel sources' numbers
(band_cull.cu and neighbor_cells.cu each as its two kernels;
dequant_boxes, cell_keys and neighbor_cells bound by bytes; cell_keys
and neighbor_cells timed alone in a CUDA graph, with their times as a
call, for cell_keys the replaced sort chain's and for neighbor_cells the
whole phase's beside them) and a
record of its own for mxu_dots_def (each with its bound: the larger of its FP32
instructions at this run's work over the 33.5T/s issue peak, for the
DEFAULT variants also its mma work over the 989 TFLOP/s bf16
tensor-core peak, and its bytes over 3.35 TB/s), and as its last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Exits non-zero, printing no result, when CUDA is unavailable or any phase
fails.  Everything it writes goes under build/chip_smoke/, apart from
the bench's quality artifact (build/rustsasa_tpu_torch/).
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SOURCE_DIR = os.path.join(ROOT, "tests", "data", "freesasa_pdbs")
EXAMPLE = os.path.join(ROOT, "tests", "data", "pdbs", "example.cif")
GOLDEN = os.path.join(ROOT, "tests", "data", "golden_example_atom_sasa.npy")
CHECK_CHUNK_SLOTS = 524_288
KERNELS = {
    "fused_count": ("rustsasa_tpu_torch/ops/csrc/fused_count.cu",
                    "rustsasa_tpu/ops/fused_kernel.py:131"),
    "list_occlusion": ("rustsasa_tpu_torch/ops/csrc/list_occlusion.cu",
                       "rustsasa_tpu/ops/pallas_kernel.py:41"),
    "pair64_count": ("rustsasa_tpu_torch/ops/csrc/pair64_count.cu",
                     "scripts/r5_pair64.py:305"),
    "nibble_count": ("rustsasa_tpu_torch/ops/csrc/nibble_count.cu",
                     "scripts/r5_pair64.py:472"),
    "saturation_count": ("rustsasa_tpu_torch/ops/csrc/saturation_count.cu",
                         "scripts/r4_saturation.py:65"),
    "micro_count": ("rustsasa_tpu_torch/ops/csrc/micro_count.cu",
                    "scripts/r4_microkernel.py:57"),
    "reach_count": ("rustsasa_tpu_torch/ops/csrc/reach_count.cu",
                    "scripts/r3_kernel_variants.py:54"),
    "maxplus_count": ("rustsasa_tpu_torch/ops/csrc/maxplus_count.cu",
                      "scripts/r3_maxplus.py:66"),
    "ke_stream": ("rustsasa_tpu_torch/ops/csrc/ke_stream.cu",
                  "scripts/kernel_experiments.py:29,116,213"),
    "ke_maxplus": ("rustsasa_tpu_torch/ops/csrc/ke_maxplus.cu",
                   "scripts/kernel_experiments.py:298"),
    "ke_bf16": ("rustsasa_tpu_torch/ops/csrc/ke_bf16.cu",
                "scripts/kernel_experiments.py:417"),
    "ke_mxu": ("rustsasa_tpu_torch/ops/csrc/ke_mxu.cu",
               "scripts/kernel_experiments.py:502"),
    # ke_mxu.cu's DEFAULT variant (wgmma), recorded beside mxu_dots_hi.
    "ke_mxu_def": ("rustsasa_tpu_torch/ops/csrc/ke_mxu.cu",
                   "scripts/kernel_experiments.py:502"),
    # The XLA stages of the JAX package's banded jit (no Pallas kernel):
    # the wire dequant and the cull's box reductions, and the rest of
    # build_jlist_banded.
    "dequant_boxes": ("rustsasa_tpu_torch/ops/csrc/band_cull.cu",
                      "rustsasa_tpu/ops/fused_kernel.py:442-470,730-744,"
                      "599-610"),
    "band_jlist": ("rustsasa_tpu_torch/ops/csrc/band_cull.cu",
                   "rustsasa_tpu/ops/fused_kernel.py:612-711"),
    # The list path's neighbor phase (XLA device code in the JAX package):
    # the cell binning and the cell-list kernel.
    "cell_keys": ("rustsasa_tpu_torch/ops/csrc/neighbor_cells.cu",
                  "rustsasa_tpu/ops/engine.py:138-211"),
    "neighbor_cells": ("rustsasa_tpu_torch/ops/csrc/neighbor_cells.cu",
                       "rustsasa_tpu/ops/engine.py:138-211"),
}
LARGEST = ("1hbn.pdb.gz", "1n62.pdb.gz", "1jz8.pdb.gz")
# csrc/band_cull.cu: FP32 instructions of one band_jlist point-box test
# (6 FSUB and 6 FMNMX for the clamped gaps, 3 FMUL and 2 FADD for pb2, 2
# FADD for rr, FMUL and FSUB for the margin, one FSETP), and of one
# dequant_boxes slot (3 FMUL and 3 FADD, 7 values through 5 shuffle
# min/max steps); the boxes' bytes a tile (16 groups x 7 floats, 7 for
# the tile).
BAND_INSTR_PER_TEST = 22
DEQUANT_INSTR_PER_SLOT = 41
BOX_BYTES_PER_TILE = 4 * (16 * 7 + 7)
BAND_KERNELS = ("dequant_boxes", "band_jlist")
# The list path's kernels: one of each a list batch.
LIST_KERNELS = ("list_occlusion", "cell_keys", "neighbor_cells")
# csrc/fused_count.cu's shared memory before the sphere (kSphereOffset):
# a 4-slot ring of 5 x 128 floats, 8 mbarriers, 32 atoms (20 bytes each)
# and the j-list row.
K1_SMEM = 4 * 4 * 5 * 128 + 8 * 8 + 20 * 32 + 4 * 132
# csrc/saturation_count.cu's before the sphere: K1_SMEM, the live
# entries' j-list positions and checks, 8 passes' stops and the
# valid-pass bits (16 bytes).
SAT_SMEM = K1_SMEM + 2 * 128 + 4 * 8 + 16
# csrc/reach_count.cu's and nibble_count.cu's before the sphere: K1_SMEM,
# the live entries' j-list positions, then their rule words (uint4) or
# nibble words (uint2).
REACH_SMEM = K1_SMEM + 128 + 16 * 128
NIBBLE_SMEM = K1_SMEM + 128 + 8 * 128
PROBE = 1.4
# H100 SXM: FP32 instruction issue peak (132 SMs x 128 lanes x 1.98 GHz;
# none of the kernels' margin instructions is a fused multiply-add) and
# HBM bandwidth.
FP32_INSTR_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12
# Dense bf16 tensor-core peak (H100 SXM data sheet).
BF16_TC_FLOPS = 989e12
# Tiles of the kernel experiments' checks (the full run takes the
# script's T = 512).
KE_CHECK_TILES = 64
# csrc/list_occlusion.cu's dynamic shared memory per CTA: two stages of
# [4 planes][16 rows][128 atoms] floats, 128 sphere points, 128 counts.
LIST_SMEM = 4 * 2 * 4 * 16 * 128 + 16 * 128 + 4 * 128
# The JAX package's gate, residue depth (BENCH_r05.json): the same q13
# counts, read back as f16.
REFERENCE_RESIDUE_RMSE = 45.9163
# Sphere sizes phase 5 also holds the list kernel to its plain version at
# on 1jz8's records: 8 and 391 blocks of points a tile.
LIST_BIG_SPHERES = (960, 50_000)
# csrc/neighbor_cells.cu: FP32 operations of one visited pair (sq_j: 3
# FMUL, 2 FADD; the cross term: FMUL, 2 FFMA; d2: FADD, FMUL, FSUB, the
# clamp; the compare) and of one record (v: 3 FSUB; v2: 3 FMUL, 2 FADD;
# nr: FADD; limit: FMUL, 2 FSUB, the division).
NEIGHBOR_OPS_PER_PAIR = 13
NEIGHBOR_OPS_PER_RECORD = 13
# csrc/neighbor_cells.cu's shared memory per CTA: the staged sorted
# positions [min(K, kStageCap)][kRows] (dynamic), the rows' counts and
# their column ranges [kRows][10] int2; its bytes an atom read once
# (packed, gid, key, sorted key, perm, sorted packed, sorted gid).
NEIGHBOR_ROWS = 16
NEIGHBOR_STAGE_CAP = 256
NEIGHBOR_BYTES_PER_ATOM = 16 + 4 + 8 + 8 + 8 + 16 + 4
# cell_keys: f64 operations an atom (r2: 3 DMUL, 2 DADD, the max; a key:
# 3 DSUB, 3 DDIV, 3 floors, 6 clamps) at the FP64 issue rate, half the
# FP32 one; bytes an atom that must move (packed and gid read; the key,
# sorted key, perm, sorted packed and sorted gid written).
CELL_KEYS_F64_PER_ATOM = 21
CELL_KEYS_BYTES_PER_ATOM = 16 + 4 + 8 + 8 + 8 + 16 + 4


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(instructions, nbytes):
    """(bound_ms, bound_by): the larger of `instructions` FP32
    instructions at the issue peak and `nbytes` at HBM bandwidth."""
    ops_ms = instructions / FP32_INSTR_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def count_bound(margins, instr_per_margin, m, p, jlist_planes=1,
                extra_out=0):
    """bound() of a count kernel over m slots and a p-point sphere that
    evaluates `margins` (j, i, point) margins: rows 0-4 of the planes,
    `jlist_planes` [m/128, 128] i32 planes and the sphere read once, the
    counts and `extra_out` more bytes written once."""
    return bound(instr_per_margin * margins,
                 4 * m * (5 + jlist_planes + 1) + 16 * p + extra_out)


def kernel1_bound(work, m, sphere, per_pair=None):
    """(bound() of kernel 1 on the work its inputs need, its FP32
    instructions): fused_kernel.needed_instructions(work, the valid
    points, per_pair) (a margin a point for each in-reach pair, a reach
    test of per_pair instructions, by default the test's arithmetic, for
    each admitted pair), its bytes as count_bound's."""
    from rustsasa_tpu_torch.ops import fused_kernel as fk

    instr = fk.needed_instructions(work, int((sphere[:, 3] > 0).sum()),
                                   per_pair or fk.REACH_INSTR_PER_PAIR)
    return bound(instr, 4 * m * 7 + 16 * sphere.shape[0]), instr


def recount_bound(rec, tag, planes, jlist, sphere, work=None):
    """Gives a count study's record the bound on the work its inputs
    need, kernel 1's since PR 13 (kernel1_bound of fused_kernel.reach_work
    on the row's own chunk and kernel 1's j-lists of it, or `work`), and
    keeps the old one on every admitted margin as old_bound_ms; logs
    both shares.  Returns the reach work."""
    from rustsasa_tpu_torch.ops import fused_kernel as fk

    if work is None:
        work = fk.reach_work(planes, jlist, sphere)
    (bound_ms, bound_by), _instr = kernel1_bound(work, planes.shape[1],
                                                 sphere)
    log(f"{tag} {rec['name']} bound on the work its inputs need "
        f"{bound_ms:.4f} ms ({bound_by}; {bound_ms / rec['ms']:.3f} of it), "
        f"on every admitted margin {rec['bound_ms']:.4f} ms "
        f"({rec['bound_ms'] / rec['ms']:.3f} of it)")
    rec.update(old_bound_ms=rec["bound_ms"], bound_ms=bound_ms,
               bound_by=bound_by)
    return work


def kernel1_reach(tag, planes, jlist, sphere, real):
    """Kernel 1's work on one chunk: fused_kernel.reach_work, and the rows
    each warp streamed (the kRows instantiation) equal to the plain
    model's, its counts byte-equal at the real slots to the main
    instantiation's; logs the j-atoms an atom (admitted, in reach of some
    atom of the tile, of 32 atoms, of 4, of itself, and streamed).
    Returns (reach_work, {column: j-atoms an atom})."""
    import torch

    from rustsasa_tpu_torch.ops import _kernels, fused_kernel as fk

    want = fk.fused_counts(planes, jlist, sphere)
    work = fk.reach_work(planes, jlist, sphere)
    passes, _k = _kernels.lane_passes(sphere.shape[0])
    got, rows = _kernels.fused_count(planes, jlist, sphere, rows=True)
    if not torch.equal(rows.long(), work["warp_rows"] * passes):
        raise AssertionError(f"{tag}: the rows streamed differ from the "
                             "plain model's")
    if not torch.equal(got[real], want[real]):
        raise AssertionError(f"{tag}: the kRows instantiation's counts "
                             "differ")
    n = work["atoms"]
    n_real = real.view(-1, rows.shape[1], fk.WARP_ATOMS).sum(dim=-1)
    per_atom = {"admitted": work["admitted"] / n,
                **{f"reach_{g}": work["reach"][g] / n
                   for g in fk.REACH_GROUPS},
                "streamed": int((rows.long() * n_real).sum()) / passes / n}
    log(f"{tag} j-atoms an atom: "
        + ", ".join(f"{k} {v:.1f}" for k, v in per_atom.items())
        + f" ({n} real atoms; {work['far']} pairs skipped by distance); "
        "the rows each warp streamed equal the plain model's")
    return work, per_atom


def record(name, launches, max_err, ms, plain_ms, vs_fused_count_ms,
           bound_ms_by):
    """One kernel's entry of the kernels line; vs_fused_count_ms is
    fused_count's time on the input `ms` was taken on (None where
    fused_count does not run on it), bound_ms_by the (bound_ms, bound_by)
    of the same work.  No single PyTorch call computes any of these
    kernels' functions, so library_ms is null."""
    source, replaces = KERNELS[name]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms_by[0],
        "bound_by": bound_ms_by[1], "library_ms": None,
        "vs_fused_count_ms": vs_fused_count_ms,
    }


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds of `fn()` over `reps` runs, after one warm run
    (none with warm=False)."""
    import torch

    if warm:
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


def graph_ms(fn, reps):
    """Mean device milliseconds of `fn()` over `reps` calls in one CUDA
    graph (`_study.graph_ms`): the host's enqueue of each call, which
    cuda_ms counts where it outlasts a short kernel, stays out."""
    from rustsasa_tpu_torch.scripts import _study

    return _study.graph_ms(fn, reps)


def ptxas_entries(log):
    """{mangled kernel name: (registers, spill store bytes)} from the
    ptxas -v report of one build."""
    entries = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        fn = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        stores = re.search(r"(\d+) bytes spill stores", chunk)
        entries[fn] = (int(regs.group(1)) if regs else None,
                       int(stores.group(1)) if stores else None)
    return entries


def redesigned_log(tag, build_log, kernel, ms, bound_ms_by, instr, fn_part,
                   smem):
    """One line for a kernel redesigned for this card: its time, bound,
    share of the bound, FP32 instructions/s at its own work, and the ptxas
    registers and spills (from its source's `build_log`) of its
    instantiation whose mangled name contains `fn_part`, beside its
    shared memory per CTA (bytes)."""
    regs = [v for fn, v in ptxas_entries(build_log).items()
            if fn_part in fn]
    if not regs:
        raise AssertionError(f"{kernel}: no ptxas report names {fn_part}")
    log(f"{tag} redesigned {kernel}: {ms:.3f} ms, bound {bound_ms_by[0]:.3f} "
        f"ms ({bound_ms_by[1]}), {bound_ms_by[0] / ms:.3f} of the bound, "
        f"{instr / (ms * 1e-3) / 1e12:.2f}T FP32 instr/s at its own work; "
        f"ptxas (registers, spill stores) {regs}; {smem} bytes of shared "
        f"memory per CTA")


class SmClocks:
    """SM clock (MHz) and power draw (W) that nvidia-smi samples every
    100 ms while the `with` block runs; summary() gives their range and
    median.  The peaks in bound() assume the data sheet's 1,980 MHz."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.samples = []
        for line in out.splitlines():
            try:
                mhz, watts = (float(v) for v in line.split(","))
            except ValueError:
                continue
            self.samples.append((mhz, watts))
        return False

    def summary(self):
        if not self.samples:
            return "no nvidia-smi samples"
        mhz = sorted(v[0] for v in self.samples)
        watts = sorted(v[1] for v in self.samples)
        return (f"SM clock {mhz[0]:.0f}-{mhz[-1]:.0f} MHz (median "
                f"{mhz[len(mhz) // 2]:.0f}), power {watts[0]:.1f}-"
                f"{watts[-1]:.1f} W over {len(mhz)} samples")


def phase_build():
    """Builds every kernel source; returns {source name: nvcc/ptxas log}."""
    from rustsasa_tpu_torch.ops import _kernels

    logs = {}
    for name, info in _kernels.build().items():
        logs[name] = info.log
        for line in info.log.splitlines():
            if "serialized" in line or "warning" in line.lower():
                log(f"[build]   {name}: {line.strip()}")
        log(f"[build] rustsasa_tpu_torch/ops/csrc/{name}.cu -> "
            f"{os.path.relpath(info.path, ROOT)} in {info.seconds:.1f}s "
            f"(nvcc {' '.join(_kernels.NVCC_FLAGS)})")
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", info.log)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill", info.log)]
        if not regs:
            raise AssertionError(f"no ptxas report for {name}:\n{info.log}")
        log(f"[build] {name}: {len(regs)} kernel instantiations, "
            f"{min(regs)}-{max(regs)} registers/thread, {sum(spills)} bytes "
            f"spilled")
        for fn, stores in re.findall(
                r"Function properties for (\S+)\n[^\n]*?(\d+) bytes spill "
                r"stores", info.log):
            if int(stores):
                log(f"[build]   {name} {fn}: {stores} bytes of spill stores")
    return logs


def band_bounds(wire, m, w):
    """(dequant_boxes, band_jlist) bound() of one chunk of m slots on
    `wire` at band width w: dequant_boxes reads the wire and writes the
    planes, qvalid and boxes (bytes); band_jlist runs T x nd x 16 x 128
    point-box tests (operations)."""
    t = m // 128
    nd = 2 * w - 1
    wire_in = 6 * m + 4 * 256 if wire == "q13" else 8 * m
    deq = bound(DEQUANT_INSTR_PER_SLOT * m,
                wire_in + 16 * t + (4 * 8 + 1) * m + BOX_BYTES_PER_TILE * t)
    band = bound(BAND_INSTR_PER_TEST * t * nd * 16 * 128,
                 (4 * 4 + 1) * m + 8 * t + BOX_BYTES_PER_TILE * t + 512 * t)
    return deq, band


def band_vs_plain(wire, arrays, tmeta, w):
    """dequant_boxes and band_jlist on one chunk against their plain
    versions on the same device tensors -> (planes, qvalid, jlist, errors,
    equal): planes, qvalid and boxes bit-equal (those of dequant_boxes
    writing no boxes too), j-lists byte-equal in all 128 columns."""
    import torch

    from rustsasa_tpu_torch.ops import _kernels, fused_kernel as fk

    planes, qvalid, boxes = getattr(_kernels, f"dequant_{wire}")(*arrays)
    bare_planes, bare_qvalid = getattr(fk, f"dequant_{wire}")(*arrays)
    jlist = _kernels.band_jlist(planes, qvalid, tmeta, boxes, w)
    want_planes, want_qvalid = getattr(fk, f"dequant_{wire}_reference")(
        *arrays)
    want_boxes = fk.tile_boxes_reference(want_planes, want_qvalid)
    want_jlist = fk.build_jlist_banded_reference(want_planes, want_qvalid,
                                                 tmeta, w=w)
    deq_equal = (torch.equal(planes.view(torch.int32),
                             want_planes.view(torch.int32))
                 and torch.equal(bare_planes.view(torch.int32),
                                 want_planes.view(torch.int32))
                 and torch.equal(qvalid, want_qvalid)
                 and torch.equal(bare_qvalid, want_qvalid)
                 and all(torch.equal(g.view(torch.int32),
                                     x.view(torch.int32))
                         for g, x in zip(boxes, want_boxes)))
    errors = (max(float((g.double() - x.double()).abs().max())
                  for g, x in zip((planes, *boxes), (want_planes, *want_boxes))),
              int((jlist.to(torch.int64) - want_jlist.to(torch.int64))
                  .abs().max()))
    return planes, qvalid, boxes, jlist, errors, (
        deq_equal, bool(torch.equal(jlist, want_jlist)))


def phase_kernel_vs_plain(corpus_dir, device, build_logs):
    """The banded chunk's three kernels and their plain versions on one
    real q13 chunk, kernel 1's work there and on r4_atombox's 2M q16
    chunk and on near-tangent pairs, then dequant_boxes and band_jlist
    over every band width on both wires; returns the kernels' JSON
    records (launches filled in later)."""
    import numpy as np
    import torch

    from rustsasa_tpu_torch.ops import _kernels, engine, fused_kernel as fk
    from rustsasa_tpu_torch.scripts import _study, r4_atombox
    from rustsasa_tpu_torch.scripts._study import load_corpus

    triples = load_corpus(corpus_dir, slots=CHECK_CHUNK_SLOTS)
    wa, wb, pal, tp, tm, offsets = fk.pack_structures_q13(triples, 1.4)
    m = wa.shape[0]
    max_nt = max(-(-t[0].shape[0] // 128) for t in triples)
    w = next(b for b in fk.W_BUCKETS if b >= max_nt)
    wire = fk.to_device((wa, wb, pal, tp, tm), device)
    sphere = engine._sphere_device(100, device)
    h2d_ms, _ = cuda_ms(
        lambda: fk.to_device((wa, wb, pal, tp, tm), device), 3
    )
    planes, qvalid, boxes, jlist, (deq_err, band_err), (deq_eq, band_eq) = (
        band_vs_plain("q13", wire[:4], wire[4], w))
    # Device time (a CUDA graph of the calls) and the time of calls back
    # to back, which holds the host's enqueue where it is the longer.
    deq_ms = graph_ms(lambda: _kernels.dequant_q13(*wire[:4]), 20)
    deq_call_ms, _ = cuda_ms(lambda: _kernels.dequant_q13(*wire[:4]), 10)
    deq_plain_ms, _ = cuda_ms(
        lambda: fk._with_boxes(fk.dequant_q13_reference)(*wire[:4]), 3)
    band_ms = graph_ms(
        lambda: _kernels.band_jlist(planes, qvalid, wire[4], boxes, w), 20)
    band_call_ms, _ = cuda_ms(
        lambda: _kernels.band_jlist(planes, qvalid, wire[4], boxes, w), 10)
    plain_boxes = fk.tile_boxes_reference(planes, qvalid)
    band_plain_ms, _ = cuda_ms(
        lambda: fk.build_jlist_banded_reference(planes, qvalid, wire[4], w=w,
                                                boxes=plain_boxes), 3)
    kernel_ms, got = cuda_ms(lambda: fk.fused_counts(planes, jlist, sphere), 10)
    plain_ms, want = cuda_ms(
        lambda: fk.fused_counts_reference(planes, jlist, sphere), 1
    )
    real = torch.zeros(m, dtype=torch.bool, device=device)
    for pos, n, _inv in offsets:
        real[pos:pos + n] = True
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    max_err = int(diff[real].max())
    all_equal = bool(torch.equal(got, want))
    n_atoms = sum(t[0].shape[0] for t in triples)
    j_per_tile = float(jlist[:, 0].double().mean())
    # Work the kernel does: every admitted 8-atom group x 128 i-atoms x
    # the padded sphere, 7 FP32 instructions per margin.
    ent = jlist[:, 1:].to(torch.int64) & 0xFFFFFFFF
    live = torch.arange(ent.shape[1], device=device) < jlist[:, 0:1]
    masks = (ent >> 16) * live
    groups = int(((masks[..., None] >> torch.arange(16, device=device)) & 1).sum())
    margins = groups * 8 * 128 * sphere.shape[0]
    rate = 7 * margins / (kernel_ms * 1e-3)
    deq_bound, band_bound = band_bounds("q13", m, w)
    log(f"[kernel] chunk: {len(triples)} structures, {n_atoms} atoms, "
        f"{m} slots ({m // 128} tiles), w={w}, full chunk on both sides, "
        f"{j_per_tile:.2f} j-tiles/tile, {groups * 8 / (m // 128):.1f} "
        f"admitted j-atoms/tile")
    log(f"[kernel] fused_count {kernel_ms:.3f} ms, plain torch "
        f"{plain_ms:.3f} ms; max |diff| at real slots {max_err}, "
        f"all slots equal: {all_equal}")
    log(f"[kernel] {margins / 1e9:.3f}G admitted margins x 7 FP32 "
        f"instructions = {rate / 1e12:.2f}T instructions/s")
    log(f"[kernel] dequant_boxes {deq_ms:.4f} ms in a CUDA graph, "
        f"{deq_call_ms:.4f} ms a call back to back (bound {deq_bound[0]:.4f} "
        f"ms, {deq_bound[1]}; {deq_bound[0] / deq_ms:.3f} of it), plain torch "
        f"{deq_plain_ms:.3f} ms; planes, qvalid and boxes bit-equal: "
        f"{deq_eq}")
    log(f"[kernel] band_jlist {band_ms:.4f} ms in a CUDA graph, "
        f"{band_call_ms:.4f} ms a call (bound {band_bound[0]:.4f} ms, "
        f"{band_bound[1]}; {band_bound[0] / band_ms:.3f} of it), plain torch "
        f"{band_plain_ms:.3f} ms; j-lists byte-equal in all 128 columns: "
        f"{band_eq}")
    log(f"[kernel] same chunk, h2d (pinned) {h2d_ms:.3f} ms; the banded "
        f"chunk's device stages {deq_ms + band_ms + kernel_ms:.3f} ms")
    if max_err != 0:
        raise AssertionError(f"kernel disagrees with plain at real slots: {max_err}")
    if not np.isfinite(kernel_ms) or int(got[real].min()) < 0:
        raise AssertionError("kernel produced no valid counts")
    if not (deq_eq and band_eq):
        raise AssertionError("the dequant or cull kernel disagrees with its "
                             "plain version on the check chunk")

    # Kernel 1 redesigned: its work, lane counts and bound on this chunk
    # and on the 2M banded q16 chunk, and near-tangent pairs.
    k1_work, per_atom = kernel1_reach("[kernel] 0.5M", planes, jlist,
                                      sphere, real)
    k1_bound, k1_instr = kernel1_bound(k1_work, m, sphere)
    sass_bound = kernel1_bound(k1_work, m, sphere, fk.REACH_INSTR_SASS)[0]
    old_bound = count_bound(margins, 7, m, sphere.shape[0])
    passes, k = _kernels.lane_passes(sphere.shape[0])
    redesigned_log(
        "[kernel]", build_logs["fused_count"],
        f"fused_count (L={_kernels.COUNT_LANES}, K={k}, {passes} pass)",
        kernel_ms, k1_bound, k1_instr, f"ILi{k}ELb0E",
        K1_SMEM + 16 * passes * _kernels.COUNT_LANES * k)
    log(f"[kernel] fused_count's bound was {old_bound[0]:.3f} ms counted on "
        f"every admitted margin ({old_bound[0] / kernel_ms:.3f} of it); on "
        f"the work these inputs need {k1_bound[0]:.4f} ms at "
        f"{fk.REACH_INSTR_PER_PAIR} FP32 instructions a reach test, "
        f"{sass_bound[0]:.4f} ms ({sass_bound[0] / kernel_ms:.3f} of it) at "
        f"the {fk.REACH_INSTR_SASS} of the kernel's SASS")
    planes4, tparams, tmeta2, real2, _atoms, n2 = r4_atombox.load_chunk(
        corpus_dir, device)
    planes2, qvalid2 = fk.dequant_q16(planes4, tparams)
    jlist2 = fk.build_jlist_banded(planes2, qvalid2, tmeta2,
                                   w=r4_atombox.W)
    ms_2m, got2 = cuda_ms(lambda: fk.fused_counts(planes2, jlist2, sphere),
                          5)
    plain_2m, want2 = cuda_ms(
        lambda: fk.fused_counts_reference(planes2, jlist2, sphere), 1,
        warm=False)
    if not torch.equal(got2[real2], want2[real2]):
        raise AssertionError("fused_count differs from plain on the 2M "
                             "q16 chunk")
    work2, per_atom2 = kernel1_reach("[kernel] 2M", planes2, jlist2, sphere,
                                     real2)
    bound_2m = kernel1_bound(work2, planes2.shape[1], sphere)[0]
    log(f"[kernel] 2M banded q16 chunk ({n2} structures, w="
        f"{r4_atombox.W}): fused_count {ms_2m:.3f} ms, plain torch "
        f"{plain_2m:.1f} ms, byte-equal at real slots; bound {bound_2m[0]:.4f}"
        f" ms ({bound_2m[0] / ms_2m:.3f} of it)")
    del planes4, tparams, planes2, qvalid2, jlist2, got2, want2
    # Near-tangent pairs, and pairs spread past tangency to where the
    # distance skip starts, with small j-radii about its guard.
    for n_points, far in ((100, False), (1000, False), (100, True),
                          (1000, True)):
        arrays = _study.tangent_chunk(n_points, 400, seed=n_points, far=far)
        t_planes, t_jlist, t_real = (torch.from_numpy(a).to(device)
                                     for a in arrays)
        t_sphere = engine._sphere_device(n_points, device)
        t_want = fk.fused_counts_reference(t_planes, t_jlist, t_sphere)
        t_work = fk.reach_work(t_planes, t_jlist, t_sphere)
        t_got, t_rows = _kernels.fused_count(t_planes, t_jlist, t_sphere,
                                             rows=True)
        t_passes = _kernels.lane_passes(n_points)[0]
        t_equal = (torch.equal(t_got[t_real], t_want[t_real])
                   and torch.equal(fk.fused_counts(
                       t_planes, t_jlist, t_sphere)[t_real], t_want[t_real])
                   and torch.equal(t_rows.long(),
                                   t_work["warp_rows"] * t_passes))
        kind = "spread past tangency" if far else "near-tangent"
        log(f"[kernel] {kind} pairs at P={n_points}: {t_work['far']} pairs "
            f"skipped by distance; fused_count byte-equal to plain and its "
            f"rows to the plain model's: {t_equal}")
        if not t_equal or (far and not t_work["far"]):
            raise AssertionError(f"fused_count differs from plain on "
                                 f"{kind} pairs, or nothing was skipped")

    # Every band width on both wires, on seeded synthetic structures
    # (a 3-atom one, two tiles of padding, bands past both chunk ends).
    for bw in fk.W_BUCKETS:
        structures = _study.band_structures(bw, seed=bw)
        nt = max(-(-st[0].shape[0] // 128) for st in structures)
        if next(b for b in fk.W_BUCKETS if b >= nt) != bw:
            raise AssertionError(f"w={bw}: the structures take another band")
        for wire_name in ("q13", "q16"):
            arrays, tmeta, _ = _study.band_chunk_wire(structures, wire_name)
            arrays = fk.to_device(arrays, device)
            tmeta = fk.to_device((tmeta,), device)[0]
            _, _, _, jl, _, (d_eq, b_eq) = band_vs_plain(wire_name, arrays,
                                                         tmeta, bw)
            dequant = getattr(fk, f"dequant_boxes_{wire_name}")

            def deq_cull():
                p, q, bx = dequant(*arrays)
                return fk.build_jlist_banded(p, q, tmeta, w=bw, boxes=bx)

            sweep_ms, _ = cuda_ms(deq_cull, 3)
            t = tmeta.shape[0]
            j = ((jl[:, 1:].to(torch.int64) & 0xFFFF) ^ 0x8000) - 0x8000
            outside = int(((j < 0) | (j >= t)).sum())
            log(f"[kernel] sweep w={bw:3d} {wire_name}: {len(structures)} "
                f"structures ({', '.join(str(st[0].shape[0]) for st in structures)} "
                f"atoms), {t} tiles; dequant bit-equal {d_eq}, j-lists "
                f"byte-equal {b_eq}; {outside} entries past the chunk's "
                f"ends; dequant + cull {sweep_ms:.4f} ms")
            if not (d_eq and b_eq) or not outside:
                raise AssertionError(f"w={bw} {wire_name}: kernels disagree "
                                     "with their plain versions")
    return [
        dict(record("fused_count", None, max_err, kernel_ms, plain_ms,
                    kernel_ms, k1_bound),
             old_bound_ms=old_bound[0], bound_ms_sass_test=sass_bound[0],
             j_atoms_per_atom=per_atom, ms_2m=ms_2m, plain_ms_2m=plain_2m,
             bound_ms_2m=bound_2m[0], j_atoms_per_atom_2m=per_atom2),
        dict(record("dequant_boxes", None, deq_err, deq_ms, deq_plain_ms,
                    kernel_ms, deq_bound), call_ms=deq_call_ms),
        dict(record("band_jlist", None, band_err, band_ms, band_plain_ms,
                    kernel_ms, band_bound), call_ms=band_call_ms),
    ]


def phase_golden(device, sample_dir, work):
    import numpy as np

    from rustsasa_tpu_torch import (
        BatchedSasaEngine, Level, SASAOptions, SasaParams,
        calculate_sasa_internal, process_directory, read_structure,
    )
    from rustsasa_tpu_torch.radii import get_vdw_radius

    s = read_structure(EXAMPLE)
    t = s.atoms
    order = list(s.iter_hierarchy_atom_indices())
    radii = np.array([get_vdw_radius(t.element[i]) for i in order], np.float32)
    sasa = calculate_sasa_internal(
        t.coords[order], radii, group_ids=t.serial[order], probe_radius=1.4,
        n_points=100, device=device,
    )
    golden = np.load(GOLDEN)
    err = np.abs(sasa - golden)
    total = SASAOptions.protein_level().process(s).protein.global_total
    log(f"[golden] example.cif per-atom max |diff| {err.max():.3f} A^2 "
        f"(mean {err.mean():.4f}, limit 25); protein total {total:.1f} "
        f"(20268.0 +- 1500)")
    if sasa.shape != golden.shape or not err.max() <= 25.0:
        raise AssertionError("example.cif per-atom SASA outside tolerance")
    if not abs(total - 20268.004) <= 1500.0:
        raise AssertionError(f"protein total {total} outside tolerance")

    outs = {}
    for dev in (device, "cpu"):
        out_dir = os.path.join(work, f"sample_out_{dev}")
        shutil.rmtree(out_dir, ignore_errors=True)
        rep = process_directory(
            sample_dir, out_dir, SASAOptions(level=Level.RESIDUE), "json",
            progress=False, engine=BatchedSasaEngine(SasaParams(), device=dev),
        )
        if rep.errors or rep.n_ok != rep.n_files:
            raise AssertionError(f"sample batch on {dev}: {rep.errors[:3]}")
        outs[dev] = {
            f: open(os.path.join(out_dir, f), "rb").read()
            for f in sorted(os.listdir(out_dir))
        }
    if outs[device] != outs["cpu"]:
        raise AssertionError("CUDA and CPU batch outputs differ")
    log(f"[golden] {len(outs['cpu'])}-file residue batch: CUDA output "
        f"byte-identical to the CPU plain-torch output")


def phase_main_path(device):
    """The main path through the port's bench (`rustsasa_tpu_torch.bench`,
    called as a function): one warm and five timed passes over the
    proteome-equivalent corpus, then the quality gate; returns the three
    main-path kernels' launches in the last timed pass ({name: n}) and
    the median pass."""
    from rustsasa_tpu_torch import bench
    from rustsasa_tpu_torch.native import pipe_library

    route = "native C++" if pipe_library() is not None else "Python"
    record = bench.run(device, WORK, say=lambda msg: log(f"[main] {msg}"))
    log(f"[main] host route {route}; median {record['median']:.3f}s, "
        f"spread {record['spread']:.4f} over passes {record['passes']}")
    log(f"[main] bench: {json.dumps(record)}")
    n_files = record["n_files"]
    if record["n_files"] < bench.TARGET_FILES or (
            record["n_atoms"] < bench.TARGET_ATOMS):
        raise AssertionError("corpus below the proteome-equivalent size")
    if record["n_ok"] != [n_files] * bench.PASSES or record["n_errors"]:
        raise AssertionError(f"files ok {record['n_ok']} of {n_files}")
    launches = record["fused_count_launches"]
    if launches != record["chunks"] or 0 in launches:
        raise AssertionError(
            f"{launches} launches for {record['chunks']} chunks")
    # One dequant_boxes a chunk on the banded and host-cull q16 wires, one
    # band_jlist a banded chunk.
    for band, routes in zip(record["band_launches"], record["routes"]):
        banded = routes["q13"] + routes["q16"]
        if not banded or band != {
                "dequant_boxes": banded + routes["host_q16"],
                "band_jlist": banded}:
            raise AssertionError(f"band launches {band} for routes {routes}")
    log(f"[main] routes of the last pass {record['routes'][-1]}; "
        f"dequant_boxes and band_jlist launches in each pass "
        f"{[list(b.values()) for b in record['band_launches']]}")
    # The bench's default engine ("cuda") deals over every visible card.
    import torch

    cards = torch.cuda.device_count()
    log(f"[main] chunks per device entry in each pass {record['entries']} "
        f"({cards} visible card(s))")
    if any(len(e) != cards or sum(e) != c
           for e, c in zip(record["entries"], record["chunks"])):
        raise AssertionError(f"entries {record['entries']} for {cards} cards")
    if not record["quality_pass"]:
        raise AssertionError("the bench's quality gate failed")
    outputs = sorted(os.listdir(os.path.join(WORK, "out")))
    if len(outputs) != n_files:
        raise AssertionError(f"{len(outputs)} outputs for {n_files} files")
    with open(os.path.join(WORK, "out", outputs[0]), encoding="utf-8") as f:
        if not json.load(f):
            raise AssertionError(f"empty output {outputs[0]}")
    return {"fused_count": launches[-1],
            **record["band_launches"][-1]}, record["median"]


def neighbor_vs_plain(got, want):
    """(max |diff| over the rows' sorted records, the parts that differ)
    of the neighbor kernel's (planes, counts, max_count) against its
    plain version's; the diff is 0.0 when they are equal."""
    import torch

    from rustsasa_tpu_torch.scripts import _study

    bad = _study.records_differ(got, want)
    a, b = (_study.record_multisets(rec[0], rec[1]).view(torch.float32)
            for rec in (got, want))
    return float((a - b).abs().nan_to_num(0.0).max()), bad


def neighbor_kernel_cases(device):
    """The binning and ordering kernels and the neighbor kernel against
    their plain versions on the seeded cases of _study.neighbor_cases and
    _study.order_cases (K = 16 there; one launch each): the CellOrder
    bit-equal, counts, max_count and each row's set of record bit
    patterns equal, and the list path's SASA at 100 points byte-equal
    from either."""
    import torch

    from rustsasa_tpu_torch.ops import _kernels, engine, neighbors
    from rustsasa_tpu_torch.scripts import _study

    sphere = engine._sphere_device(100, device)
    cases = [*_study.neighbor_cases(),
             *((name, packed, gid, 16)
               for name, packed, gid in _study.order_cases())]
    for name, packed, gid, k in cases:
        packed, gid = (torch.from_numpy(a).to(device) for a in (packed, gid))
        keys_equal = cell_keys_vs_plain(packed, gid)
        before = dict(_kernels.launch_counts)
        got = neighbors.neighbor_records(packed, gid, probe=PROBE, k=k)
        launches = [_kernels.launch_counts[n] - before[n]
                    for n in ("cell_keys", "neighbor_cells")]
        want = neighbors.neighbor_records_reference(packed, gid, probe=PROBE,
                                                    k=k)
        err, bad = neighbor_vs_plain(got, want)
        equal = bool(torch.equal(*(neighbors.records_sasa(
            rec, packed, gid, sphere, probe=PROBE, n_points=100)
            for rec in (got, want))))
        log(f"[neighbor] {name}: B={gid.shape[0]}, N={gid.shape[1]}, "
            f"K={got[0].shape[1]}, max count {int(got[2])}; cell_keys "
            f"bit-equal to its plain version (cell_grid, a stable sort, the "
            f"gathers): {keys_equal}; counts, max_count and "
            f"records equal to plain: {not bad} (max |diff| {err}); SASA "
            f"byte-equal: {equal}; cell_keys and neighbor_cells launches "
            f"{launches}")
        if bad or not equal or not keys_equal or launches != [1, 1]:
            raise AssertionError(f"neighbor kernels on {name}: {bad}, SASA "
                                 f"equal {equal}, keys equal {keys_equal}, "
                                 f"{launches} launches")


def cell_keys_vs_plain(packed, gid):
    """Whether the binning and ordering kernels' outputs (keys, max_r,
    cell edges, sorted keys, perm, sorted packed and sorted gid) are
    bit-equal to neighbors.cell_order_reference's (cell_grid, a stable
    torch.sort and the gathers, on the CPU)."""
    import torch

    from rustsasa_tpu_torch.ops import _kernels, neighbors

    got = _kernels.cell_keys(packed, gid, PROBE)
    want = neighbors.cell_order_reference(packed.cpu(), gid.cpu(), PROBE)
    return all(g.dtype == w.dtype and g.shape == w.shape and torch.equal(
        g.cpu().view(torch.uint8), w.view(torch.uint8))
        for g, w in zip(got, want))


def phase_list_kernel(device, build_logs):
    """Phase 5: the list path's three kernels against their plain
    versions: the binning and neighbor kernels on the seeded cases, then
    on the largest test structure the list kernel on the neighbor
    phase's records and the neighbor phase (each kernel, the sort, the
    whole phase, the plain versions); returns their JSON records (list,
    binning, neighbor)."""
    import torch

    from rustsasa_tpu_torch.ops import _kernels, engine, neighbors
    from rustsasa_tpu_torch.scripts import _study, layout_probe

    neighbor_kernel_cases(device)
    _kernels.reset_launch_counts()
    rec = layout_probe.list_records(device, os.path.join(SOURCE_DIR,
                                                         LARGEST[-1]))
    runs = _kernels.launch_counts["neighbor_cells"]
    if runs != rec["runs"] or _kernels.launch_counts["cell_keys"] != runs or (
            _kernels.launch_counts["list_occlusion"]):
        raise AssertionError(f"{rec['runs']} neighbor phases, launches "
                             f"{_kernels.launch_counts}")
    planes, area, sphere, kmax = (rec[key] for key in
                                  ("planes", "area", "sphere", "kmax"))
    kernel_ms, got = cuda_ms(
        lambda: _kernels.list_occlusion(*planes, area, sphere, kmax), 20
    )
    plain_ms, want = cuda_ms(
        lambda: neighbors.occlusion_sasa_reference(
            *planes, area, sphere, kmax), 3
    )
    max_err = float((got - want).abs().max())
    equal = bool(torch.equal(got, want))
    kdim, n_pad = planes[0].shape
    n = rec["n"]
    kd = kmax.double()
    log(f"[list-kernel] {LARGEST[-1]}: {n} atoms, N={n_pad} slots, "
        f"K={kdim} (max candidates {rec['max_count']}), P={sphere.shape[0]}"
        f"; tile bound min {int(kmax.min())}, mean {float(kd.mean()):.1f}, "
        f"max {int(kmax.max())} over {kmax.numel()} tiles; neighbor phase "
        f"{rec['neighbor_s'] * 1e3:.1f} ms (host clock, first call, "
        f"{runs} launch(es))")
    # The wrapper's host time per call: its checks, allocations and
    # launches, enqueued back to back ahead of the card.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        _kernels.list_occlusion(*planes, area, sphere, kmax)
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    log(f"[list-kernel] list_occlusion {kernel_ms:.4f} ms (host "
        f"{host_us:.1f} us a call), plain torch {plain_ms:.3f} ms; max "
        f"|diff| {max_err}, byte-equal: {equal}")
    if not equal or not bool(torch.isfinite(got).all()):
        raise AssertionError("list kernel disagrees with its plain version")
    if not bool((got[:n] > 0).any()):
        raise AssertionError("list kernel found no accessible surface")
    # Spheres over 128 points: several blocks of points a tile, their
    # counts added with atomicAdd and finished by a second kernel, on more
    # CTAs than the card holds at once (2 a SM).
    for p_big in LIST_BIG_SPHERES:
        big = engine._sphere_device(p_big, device)
        blocks = _kernels.list_point_plan(p_big)[0]
        ms_big, got_big = cuda_ms(
            lambda b=big: _kernels.list_occlusion(*planes, area, b, kmax), 3)
        want_big = neighbors.occlusion_sasa_reference(*planes, area, big,
                                                      kmax)
        equal_big = bool(torch.equal(got_big, want_big))
        log(f"[list-kernel] list_occlusion at P={p_big}: {blocks} blocks of "
            f"points, {blocks * kmax.numel()} CTAs, {ms_big:.4f} ms; "
            f"byte-equal to plain torch: {equal_big}")
        if not equal_big:
            raise AssertionError(f"list kernel at P={p_big} disagrees with "
                                 "its plain version")
    # Work: LIST_INSTR_PER_TRIPLE per (point, atom, k < the tile's bound);
    # bytes: those records (vx, vy, vz, limit), area, sphere, tile bounds
    # and the output.
    k_rows = int(kmax.to(torch.int64).clamp(max=kdim).sum()) * 128
    p = sphere.shape[0]
    instr = _kernels.LIST_INSTR_PER_TRIPLE * k_rows * p
    work = bound(instr, 16 * k_rows + 8 * n_pad + 16 * p + 4 * kmax.numel())
    redesigned_log("[list-kernel]", build_logs["list_occlusion"],
                   "list_occlusion (1jz8)", kernel_ms, work, instr,
                   "list_occlusion_kernel", LIST_SMEM)
    listed = record("list_occlusion", None, max_err, kernel_ms, plain_ms,
                    None, work)

    # The neighbor phase on 1jz8: the binning and ordering (cell_keys) and
    # the cell-list kernel each alone and the whole phase warm, in a CUDA
    # graph and as calls back to back; the chain the ordering replaced (a
    # stable torch.sort of the keys and two index_selects); the plain
    # versions (cell_order_reference; the expansion and top-k with their
    # K-major copies).
    packed, gid, k = rec["packed"], rec["gid"], rec["k"]
    keys_equal = cell_keys_vs_plain(packed, gid)
    order = _kernels.cell_keys(packed, gid, PROBE)
    keys, max_r, h = order.keys, order.max_r, order.h
    m = gid.numel()

    def kernel():
        return _kernels.neighbor_cells(
            packed, gid, max_r, keys, order.sorted_keys, order.perm,
            order.sorted_packed, order.sorted_gid, probe=PROBE, k=k)

    def binning():
        return _kernels.cell_keys(packed, gid, PROBE)

    def sort_chain():
        sorted_keys, perm = torch.sort(keys, stable=True)
        return (sorted_keys, packed.reshape(m, 4).index_select(0, perm),
                gid.reshape(m).index_select(0, perm))

    def phase():
        return neighbors.neighbor_records(packed, gid, probe=PROBE, k=k)

    def plain():
        return neighbors.neighbor_records_reference(packed, gid, probe=PROBE,
                                                    k=k)

    nb_graph_ms = graph_ms(kernel, 20)
    nb_call_ms, _ = cuda_ms(kernel, 20)
    keys_graph_ms = graph_ms(binning, 20)
    keys_call_ms, _ = cuda_ms(binning, 20)
    sort_graph_ms = graph_ms(sort_chain, 20)
    sort_call_ms, _ = cuda_ms(sort_chain, 20)
    phase_graph_ms = graph_ms(phase, 20)
    phase_call_ms, mine = cuda_ms(phase, 20)
    keys_plain_ms, _ = cuda_ms(lambda: neighbors.cell_order_reference(
        packed, gid, PROBE), 20)
    nb_plain_ms, theirs = cuda_ms(plain, 3)
    v, limit, _c, _m = neighbors._neighbor_phase(packed[0], gid[0],
                                                  probe=PROBE, k=k)
    copy_ms, _ = cuda_ms(lambda: neighbors.k_major(v, limit, n_pad), 20)
    nb_err, bad = neighbor_vs_plain(mine, theirs)
    log(f"[neighbor] {LARGEST[-1]}: kernel {nb_graph_ms:.4f} ms in a graph, "
        f"{nb_call_ms:.4f} ms a call; cell_keys (binning and ordering) "
        f"{keys_graph_ms:.4f} ms in a graph, {keys_call_ms:.4f} ms a call "
        f"(plain cell_order_reference on the card {keys_plain_ms:.4f} ms), "
        f"bit-equal to it: {keys_equal}; the chain the ordering replaced "
        f"(stable torch.sort, two index_selects) {sort_graph_ms:.4f} ms in a "
        f"graph, {sort_call_ms:.4f} ms a call; the phase (cell_keys, "
        f"neighbor_cells) {phase_graph_ms:.4f} ms in a graph, "
        f"{phase_call_ms:.4f} ms a call; plain (expansion, top-k, K-major "
        f"copies) {nb_plain_ms:.3f} ms, its copies {copy_ms:.4f} ms; cell "
        f"edge {float(h[0]):.4f} A; "
        f"counts, max_count and records equal: {not bad} (max |diff| "
        f"{nb_err})")
    if bad or not keys_equal:
        raise AssertionError(f"neighbor kernels on {LARGEST[-1]}: {bad}, "
                             f"keys equal {keys_equal}")
    for n_points in (100, *LIST_BIG_SPHERES):
        ball = engine._sphere_device(n_points, device)
        same = bool(torch.equal(*(neighbors.records_sasa(
            r, packed, gid, ball, probe=PROBE, n_points=n_points)
            for r in (mine, theirs))))
        log(f"[neighbor] {LARGEST[-1]} list SASA at P={ball.shape[0]} from "
            f"kernel-made and plain-made records byte-equal: {same}")
        if not same:
            raise AssertionError(f"list SASA at P={ball.shape[0]} differs "
                                 "between the two record sets")
    # Bound: bytes of the kernel's inputs read once and its outputs
    # written once (the K x N4 records, counts, max_count); operations:
    # each visited pair's test and each kept record, by this run's cells.
    b = gid.shape[0]
    visits = int(_study.visited_pairs(keys, order.sorted_keys).sum())
    kept = int(mine[1].clamp(max=k).sum())
    ops = NEIGHBOR_OPS_PER_PAIR * visits + NEIGHBOR_OPS_PER_RECORD * kept
    nbytes = NEIGHBOR_BYTES_PER_ATOM * m + 4 * b + 16 * k * n_pad + 4 * m + 4
    nb_bound = bound(ops, nbytes)
    smem = (4 * min(k, NEIGHBOR_STAGE_CAP) * NEIGHBOR_ROWS
            + 4 * NEIGHBOR_ROWS + 8 * NEIGHBOR_ROWS * 10)
    log(f"[neighbor] bound {nb_bound[0]:.4f} ms ({nb_bound[1]}: {nbytes} "
        f"bytes, {ops} FP32 operations for {visits} visited pairs and "
        f"{kept} records, {visits / n:.1f} and {kept / n:.1f} an atom)")
    redesigned_log("[neighbor]", build_logs["neighbor_cells"],
                   "neighbor_cells (1jz8, in a graph)", nb_graph_ms, nb_bound,
                   ops, "neighbor_cells_kernel", smem)
    neighbor = record("neighbor_cells", None, nb_err, nb_graph_ms, nb_plain_ms,
                      None, nb_bound)
    neighbor.update(call_ms=nb_call_ms, phase_graph_ms=phase_graph_ms,
                    phase_call_ms=phase_call_ms, copy_ms=copy_ms)
    keys_bound = bound(2 * CELL_KEYS_F64_PER_ATOM * m,
                       CELL_KEYS_BYTES_PER_ATOM * m + 12 * b)
    regs = {kernel: v for fn, v in ptxas_entries(
        build_logs["neighbor_cells"]).items()
        for kernel in ("cell_keys_kernel", "cell_order_kernel")
        if kernel in fn}
    log(f"[neighbor] cell_keys bound {keys_bound[0]:.5f} ms "
        f"({keys_bound[1]}: {CELL_KEYS_BYTES_PER_ATOM * m + 12 * b} bytes), "
        f"{keys_bound[0] / keys_graph_ms:.3f} of it in a graph; ptxas "
        f"(registers, spill stores) {regs}")
    binned = record("cell_keys", None, 0.0, keys_graph_ms, keys_plain_ms,
                    None, keys_bound)  # bit-equal, checked above
    binned.update(call_ms=keys_call_ms, replaced_graph_ms=sort_graph_ms,
                  replaced_call_ms=sort_call_ms)
    return listed, binned, neighbor


ANALYTIC = (
    # (name, atoms (x, y, z, radius), expected SASA per atom)
    ("single sphere", [(0, 0, 0, 2.0)], [4 * math.pi * 3.4 ** 2]),
    ("two overlapping", [(0, 0, 0, 2.0), (4, 0, 0, 2.0)],
     [4 * math.pi * 3.4 ** 2 - 2 * math.pi * 3.4 * (3.4 - 2.0)] * 2),
    ("three in a line", [(0, 0, 0, 2.0), (5, 0, 0, 2.0), (10, 0, 0, 2.0)],
     [4 * math.pi * 3.4 ** 2 - k * 2 * math.pi * 3.4 * (3.4 - 2.5)
      for k in (1, 2, 1)]),
)


def phase_list_path(device):
    """The list path end to end; returns the list path's two kernels'
    launches ({name: n})."""
    import numpy as np

    from rustsasa_tpu_torch import (
        Level, SASAOptions, calculate_sasa_internal, read_structure,
    )
    from rustsasa_tpu_torch.levels import aggregate
    from rustsasa_tpu_torch.radii import get_vdw_radius
    from rustsasa_tpu_torch.ops import _kernels

    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    s = read_structure(EXAMPLE)
    t = s.atoms
    order = list(s.iter_hierarchy_atom_indices())
    radii = np.array([get_vdw_radius(t.element[i]) for i in order], np.float32)
    sasa = calculate_sasa_internal(
        t.coords[order], radii, group_ids=t.serial[order], probe_radius=PROBE,
        n_points=100, backend="list", device=device,
    )
    err = np.abs(sasa - np.load(GOLDEN))
    sel = SASAOptions.protein_level().build_selection(s)
    total = aggregate(sel, calculate_sasa_internal(
        sel.coords, sel.radii, group_ids=sel.group_ids, probe_radius=PROBE,
        n_points=100, backend="list", device=device,
    ), Level.PROTEIN).protein.global_total
    log(f"[list] example.cif per-atom max |diff| {err.max():.3f} A^2 (mean "
        f"{err.mean():.4f}, limit 25); protein total {total:.1f} "
        f"(20268.0 +- 1500); {time.perf_counter() - t0:.2f}s")
    if not err.max() <= 25.0 or not abs(total - 20268.004) <= 1500.0:
        raise AssertionError("list path outside the golden tolerances")
    for name, atoms, expected in ANALYTIC:
        t0 = time.perf_counter()
        got = calculate_sasa_internal(
            np.array([a[:3] for a in atoms], np.float32),
            np.array([a[3] for a in atoms], np.float32),
            probe_radius=PROBE, n_points=50_000, device=device,
        )
        rel = max(abs(g - e) / e for g, e in zip(got, expected))
        log(f"[list] {name} at 50,000 points: max relative error "
            f"{rel:.2e} (limit 5e-3); {time.perf_counter() - t0:.3f}s")
        if not rel <= 0.005:
            raise AssertionError(f"{name}: relative error {rel}")
    launches = dict(_kernels.launch_counts)
    log(f"[list] launches: {launches}")
    if launches["list_occlusion"] == 0 or launches["fused_count"] != 0 or (
            launches["neighbor_cells"] != launches["list_occlusion"]) or (
            launches["cell_keys"] != launches["list_occlusion"]):
        raise AssertionError(f"list path launches {launches}")
    return {k: launches[k] for k in LIST_KERNELS}


def phase_host_cull(device, work):
    """All 88 FreeSASA structures on CUDA, routes counted; the largest
    three byte-identical to the CPU; the f32 wire exact against the CPU."""
    import numpy as np

    from rustsasa_tpu_torch import (
        BatchedSasaEngine, Level, SASAOptions, SasaParams, process_directory,
    )
    from rustsasa_tpu_torch.ops import _kernels
    from rustsasa_tpu_torch.scripts._study import select

    options = SASAOptions(level=Level.RESIDUE)
    n_files = len(os.listdir(SOURCE_DIR))
    out_dir = os.path.join(work, "freesasa_out_cuda")
    shutil.rmtree(out_dir, ignore_errors=True)
    engine = BatchedSasaEngine(SasaParams(), device=device)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = process_directory(SOURCE_DIR, out_dir, options, "json",
                               progress=False, engine=engine)
    elapsed = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    routes = engine.routes.counts
    log(f"[host-cull] {report.n_ok}/{report.n_files} FreeSASA structures on "
        f"CUDA in {elapsed:.3f}s; chunks by route {routes}; launches "
        f"{launches}")
    if report.n_ok != n_files or report.errors:
        raise AssertionError(f"{report.n_ok}/{n_files} ok: {report.errors[:3]}")
    if routes["host_q16"] < 1:
        raise AssertionError("no chunk took the host-cull q16 wire")
    if (launches["fused_count"] != engine.chunks_dispatched
            or launches["list_occlusion"] != routes["list"]
            or launches["neighbor_cells"] != routes["list"]
            or launches["cell_keys"] != routes["list"]):
        raise AssertionError(f"launches {launches} for routes {routes}")

    # Each route's share: its structures alone, selected in advance, one
    # warm and three timed computes (host clock; pack, copies, device
    # and readback).
    triples = {f: select(os.path.join(SOURCE_DIR, f))
               for f in sorted(os.listdir(SOURCE_DIR))}
    rest = [t for f, t in triples.items() if f not in LARGEST]
    groups = {
        f"the other {len(rest)}": rest,
        LARGEST[0] + " + " + LARGEST[1]: [triples[f] for f in LARGEST[:2]],
        LARGEST[2]: [triples[LARGEST[2]]],
    }
    for label, group in groups.items():
        BatchedSasaEngine(SasaParams(), device=device).compute(group)
        eng = BatchedSasaEngine(SasaParams(), device=device)
        t0 = time.perf_counter()
        for _ in range(3):
            eng.compute(group)
        per = (time.perf_counter() - t0) / 3
        routes = {k: v // 3 for k, v in eng.routes.counts.items() if v}
        log(f"[host-cull] {label}: {sum(t[0].shape[0] for t in group)} "
            f"atoms in {per * 1e3:.1f} ms per compute; routes {routes}")

    big_dir = os.path.join(work, "largest")
    shutil.rmtree(big_dir, ignore_errors=True)
    os.makedirs(big_dir)
    for name in LARGEST:
        os.symlink(os.path.join(SOURCE_DIR, name), os.path.join(big_dir, name))
    cpu_out = os.path.join(work, "largest_out_cpu")
    shutil.rmtree(cpu_out, ignore_errors=True)
    cpu_engine = BatchedSasaEngine(SasaParams(), device="cpu")
    t0 = time.perf_counter()
    cpu_report = process_directory(big_dir, cpu_out, options, "json",
                                   progress=False, engine=cpu_engine)
    log(f"[host-cull] {', '.join(LARGEST)} on the CPU (plain torch) in "
        f"{time.perf_counter() - t0:.1f}s; routes {cpu_engine.routes.counts}")
    if cpu_report.n_ok != len(LARGEST):
        raise AssertionError(f"CPU run: {cpu_report.errors}")
    for name in sorted(os.listdir(cpu_out)):
        with open(os.path.join(cpu_out, name), "rb") as f:
            want = f.read()
        with open(os.path.join(out_dir, name), "rb") as f:
            if f.read() != want:
                raise AssertionError(f"{name}: CUDA and CPU JSON differ")
    log(f"[host-cull] JSON of {', '.join(sorted(os.listdir(cpu_out)))} "
        f"byte-identical on CUDA and on the CPU")

    coords, radii, gids = select(EXAMPLE)
    gids = gids.copy()
    # An alt-loc-style collision that lowers the largest dense id: the
    # engine then sees the ids as shared (max < n - 1).
    gids[gids.argmax()] = gids[0]
    outs = {}
    for dev in (device, "cpu"):
        eng = BatchedSasaEngine(SasaParams(), device=dev)
        outs[dev] = eng.compute([(coords, radii, gids)])[0]
        if eng.routes.counts["f32"] != 1:
            raise AssertionError(f"routes on {dev}: {eng.routes.counts}")
    if not np.array_equal(outs[device], outs["cpu"]):
        raise AssertionError("f32 wire: CUDA and CPU areas differ")
    log(f"[host-cull] shared-gid example.cif ({coords.shape[0]} atoms) "
        f"through the f32 wire: CUDA areas equal the CPU's exactly "
        f"(total {float(outs['cpu'].sum()):.3f})")


def _kernel_vs_plain(name, kernel, plain, prod, real, equal_to_prod=True):
    """Time a study kernel (10 launches) and its plain version (one call,
    no warm call: it takes seconds, and twice that would hold the smoke
    past its time budget) on the same tensors; every output byte-equal to
    the plain version's and, with
    equal_to_prod, the counts equal to fused_count's `prod` at the `real`
    slots (else their difference is only reported).  Returns (ms,
    plain_ms, max |diff| over the outputs, kernel outputs)."""
    import torch

    ms, got = cuda_ms(kernel, 10)
    plain_ms, want = cuda_ms(plain, 1, warm=False)
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    max_err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    d_prod = (got[0].to(torch.int64) - prod.to(torch.int64)).abs()[real]
    log(f"[studies] {name} {ms:.3f} ms, plain torch {plain_ms:.3f} ms; "
        f"byte-equal to plain: {equal} (max |diff| {max_err}); |count - "
        f"fused_count| at real slots: max {int(d_prod.max())}, mean "
        f"{float(d_prod.double().mean()):.6f}")
    if not equal or (equal_to_prod and int(d_prod.max()) != 0):
        raise AssertionError(f"{name}: disagrees with its plain version or "
                             f"with fused_count")
    return ms, plain_ms, max_err, got


def nibble_packing(planes, jlist, lists, sphere, prod, real, device):
    """Whether packing four admitted groups into a reach chunk pays:
    nibble_count.cu built with kernel 1's keep_pair in place of keep_row
    (a timing-only cut build: it drops padding atoms' rows as kernel 1
    does, so only the packing differs from fused_count), its counts equal
    fused_count's at the real slots, then fused_count, the cut build and
    nibble_count timed in two rounds of turns on the banded chunk; logs
    the medians."""
    import statistics

    import torch

    from rustsasa_tpu_torch.ops import _kernels, fused_kernel as fk
    from rustsasa_tpu_torch.scripts import r5_pair64 as r5

    fns = _kernels.build_sources(
        "nibble_packing", _kernels.cut_sources("nibble_count", [(
            "keep_pair", [("rows_keep<kKeepRow>(", "rows_keep<kKeepPair>(")],
        )]), "nibble_count_launch", _kernels._SIGNATURES["nibble_count"])
    m, p = planes.shape[1], sphere.shape[0]
    out = torch.empty(m, dtype=torch.int32, device=device)

    def cut():
        rc = fns["keep_pair"](
            planes.data_ptr(), *(t.data_ptr() for t in lists),
            sphere.data_ptr(), out.data_ptr(), m, p,
            torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nibble_count_launch (keep_pair): {rc}")
        return out

    if not torch.equal(cut()[real], prod[real]):
        raise AssertionError("nibble_count with keep_pair differs from "
                             "fused_count at real slots")
    calls = {"fused_count": lambda: fk.fused_counts(planes, jlist, sphere),
             "nibble_keep_pair": cut,
             "nibble_count": lambda: r5.nibble_counts(planes, *lists, sphere)}
    times = {name: [] for name in calls}
    for _ in range(2):
        for name, fn in calls.items():
            times[name].append(cuda_ms(fn, 10)[0])
    med = {name: statistics.median(v) for name, v in times.items()}
    log("[studies] packing, in turns (medians of two rounds, ms): "
        + ", ".join(f"{k} {v:.4f} ({v / med['fused_count']:.3f}x)"
                    for k, v in med.items())
        + "; nibble_keep_pair is nibble_count.cu with kernel 1's keep_pair "
        "(a timing-only cut build): only the packing differs from "
        "fused_count")


def phase_count_studies(corpus_dir, device, build_logs):
    """Phase 8: the count-kernel studies.  Each study kernel against its
    plain version and fused_count on a corpus chunk, then both studies'
    run() at full size, kernels only, with the launches of those runs.
    Returns the three kernels' records."""
    import torch

    from rustsasa_tpu_torch.ops import _kernels, engine, fused_kernel as fk
    from rustsasa_tpu_torch.scripts import _study
    from rustsasa_tpu_torch.scripts import r4_saturation as r4
    from rustsasa_tpu_torch.scripts import r5_pair64 as r5

    t_phase = time.perf_counter()
    sphere = engine._sphere_device(100, device)
    triples = _study.load_corpus(corpus_dir, slots=CHECK_CHUNK_SLOTS,
                                 max_tiles=r5.W)

    # Banded q16 at w = 32: pair64 and nibble.
    planes, qvalid, tm, real, n_atoms, _tiles = _study.banded_chunk(
        triples, device, CHECK_CHUNK_SLOTS)
    build_ms = {}
    build_ms["banded"], jlist = cuda_ms(
        lambda: fk.build_jlist_banded_reference(planes, qvalid, tm, w=r5.W),
        3)
    build_ms["banded_kernel"], jlist_kernel = cuda_ms(
        lambda: fk.build_jlist_banded(planes, qvalid, tm, w=r5.W), 3)
    if not torch.equal(jlist_kernel, jlist):
        raise AssertionError("band_jlist differs from the plain builder on "
                             "the studies' chunk")
    build_ms["banded_2h"], (jlist_a, jmask_b) = cuda_ms(
        lambda: r5.build_jlist_banded_2h(planes, qvalid, tm, w=r5.W), 3)
    build_ms["nibble"], (jl, w1, w2) = cuda_ms(
        lambda: r5.build_jlist_nibble(planes, qvalid, tm, w=r5.W), 3)
    prod_ms, prod = cuda_ms(lambda: fk.fused_counts(planes, jlist, sphere), 10)
    log(f"[studies] banded q16 chunk: {len(triples)} structures, {n_atoms} "
        f"atoms, {planes.shape[1]} slots, w={r5.W}; builders "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in build_ms.items())
        + f"; fused_count {prod_ms:.3f} ms")
    m, p = planes.shape[1], sphere.shape[0]
    passes, k = _kernels.point_passes(p)
    points = passes * _kernels.SLICES * k
    lane_margins = 8 * 128 // 2 * points  # per lane-weighted group
    records = {}
    ms, plain_ms, err, _ = _kernel_vs_plain(
        "pair64_count",
        lambda: r5.pair64_counts(planes, jlist_a, jmask_b, sphere),
        lambda: r5.pair64_counts_reference(planes, jlist_a, jmask_b, sphere),
        prod, real)
    records["pair64_count"] = record(
        "pair64_count", None, err, ms, plain_ms, prod_ms, count_bound(
            int(_study.streamed_groups(jlist_a, jmask_b).sum()) * lane_margins,
            7, m, p, jlist_planes=2))
    ms, plain_ms, err, _ = _kernel_vs_plain(
        "nibble_count",
        lambda: r5.nibble_counts(planes, jl, w1, w2, sphere),
        lambda: r5.nibble_counts_reference(planes, jl, w1, w2, sphere),
        prod, real)
    records["nibble_count"] = record(
        "nibble_count", None, err, ms, plain_ms, prod_ms, count_bound(
            int(_study.streamed_groups(jlist).sum()) * lane_margins, 7, m, p,
            jlist_planes=3))
    work = recount_bound(records["pair64_count"], "[studies]", planes, jlist,
                         sphere)
    recount_bound(records["nibble_count"], "[studies]", planes, jlist, sphere,
                  work)
    lpasses, lk = _kernels.lane_passes(p)
    pair_ms = records["pair64_count"]["ms"]
    staged = r5.pair64_staged(jlist, jlist_a, jmask_b)
    log(f"[studies] pair64_count {pair_ms / prod_ms:.3f}x fused_count on the "
        f"same chunk; a CTA stages (4 CTAs a tile): pair64 "
        f"{staged['pair64']['entries']:.3f} live entries and "
        f"{staged['pair64']['chunks']:.3f} reach chunks, fused_count "
        f"{staged['prod']['entries']:.3f} and {staged['prod']['chunks']:.3f} "
        f"({staged['pair64']['entries'] / staged['prod']['entries']:.4f} and "
        f"{staged['pair64']['chunks'] / staged['prod']['chunks']:.4f} of "
        f"its)")
    redesigned_log(
        "[studies]", build_logs["pair64_count"],
        f"pair64_count (L={_kernels.COUNT_LANES}, K={lk}, {lpasses} "
        f"pass(es), a half's entries a CTA)", pair_ms,
        (records["pair64_count"]["bound_ms"],
         records["pair64_count"]["bound_by"]),
        fk.needed_instructions(work, int((sphere[:, 3] > 0).sum())),
        f"pair64_count_kernelILi{lk}E",
        K1_SMEM + 16 * lpasses * _kernels.COUNT_LANES * lk)
    regs = ptxas_entries(build_logs["pair64_count"])
    log("[studies] pair64_count ptxas (registers, spill stores) by K: "
        + ", ".join(f"K={kk} {v}" for kk in (1, 7, 16)
                    for fn, v in regs.items()
                    if f"pair64_count_kernelILi{kk}E" in fn))
    chunks = {name: r5.reach_chunks(lst, nibble=name == "nibble")
              for name, lst in (("nibble", jl), ("prod", jlist))}
    log(f"[studies] nibble_count {ms / prod_ms:.3f}x fused_count on the same "
        f"chunk; reach chunks a live entry: nibble "
        f"{chunks['nibble'][0] / max(chunks['nibble'][1], 1):.4f} (packed), "
        f"fused_count {chunks['prod'][0] / max(chunks['prod'][1], 1):.4f} "
        f"({chunks['nibble'][0]} of {chunks['prod'][0]} chunks, "
        f"{chunks['prod'][1]} live entries)")
    redesigned_log(
        "[studies]", build_logs["nibble_count"],
        f"nibble_count (L={_kernels.COUNT_LANES}, K={lk}, {lpasses} "
        f"pass(es), four groups a chunk)", ms,
        (records["nibble_count"]["bound_ms"],
         records["nibble_count"]["bound_by"]),
        fk.needed_instructions(work, int((sphere[:, 3] > 0).sum())),
        f"nibble_count_kernelILi{lk}E",
        NIBBLE_SMEM + 16 * lpasses * _kernels.COUNT_LANES * lk)
    nibble_packing(planes, jlist, (jl, w1, w2), sphere, prod, real, device)

    # Host-cull f32: saturation checked every 1, 2 and 4 entries, on
    # kernel 1's layout and point split.
    planes5, jlist5, real5, _atoms, _tiles, failed = _study.host_cull_chunk(
        triples, device, CHECK_CHUNK_SLOTS)
    if failed:
        raise AssertionError(f"{failed} host j-lists overflowed")
    entries = lpasses * int(jlist5[:, 0].sum())
    margins5 = (int(_study.streamed_groups(jlist5).sum()) * 8 * 128 // 2
                * lpasses * _kernels.COUNT_LANES * lk)
    prod5_ms, prod5 = cuda_ms(lambda: fk.fused_counts(planes5, jlist5, sphere),
                              10)
    log(f"[studies] host-cull f32 chunk: {entries} j-list entries over "
        f"{lpasses} point pass(es); fused_count {prod5_ms:.3f} ms")
    work5 = fk.reach_work(planes5, jlist5, sphere)
    for ce in r4.CHECKS:
        ms, plain_ms, err, (_, streamed) = _kernel_vs_plain(
            f"saturation_count (check_every={ce})",
            lambda ce=ce: r4.saturation_counts(planes5, jlist5, sphere,
                                               check_every=ce),
            lambda ce=ce: r4.saturation_counts_reference(
                planes5, jlist5, sphere, check_every=ce),
            prod5, real5)
        sat_bound = kernel1_bound(work5, planes5.shape[1], sphere)[0]
        log(f"[studies]   skipped {entries - int(streamed.sum())} of "
            f"{entries} entries; {ms / prod5_ms:.3f}x fused_count on the "
            f"same chunk; {sat_bound[0] / ms:.3f} of the bound on the work "
            f"its inputs need")
        if ce == 1:
            # The margins of the entries it streamed (all on this corpus).
            work = margins5 * int(streamed.sum()) // max(entries, 1)
            m5 = planes5.shape[1]
            records["saturation_count"] = dict(
                record("saturation_count", None, err, ms, plain_ms, prod5_ms,
                       count_bound(work, 7, m5, p, extra_out=4 * m5 // 128)),
                check_every=1)
            recount_bound(records["saturation_count"], "[studies]", planes5,
                          jlist5, sphere, work5)
            redesigned_log(
                "[studies]", build_logs["saturation_count"],
                f"saturation_count (check_every=1, L={_kernels.COUNT_LANES}, "
                f"K={lk}, {lpasses} pass(es), 4 CTAs a tile)",
                ms, (records["saturation_count"]["bound_ms"],
                     records["saturation_count"]["bound_by"]),
                fk.needed_instructions(work5, int((sphere[:, 3] > 0).sum())),
                f"ILi{lk}E", SAT_SMEM + 16 * lpasses * _kernels.COUNT_LANES * lk)

    # Full size: the studies' own entry, kernels only.
    t0 = time.perf_counter()
    full = _study.load_corpus(corpus_dir, max_tiles=r5.W)
    log(f"[studies] full-size chunk: {len(full)} structures selected in "
        f"{time.perf_counter() - t0:.1f}s")
    _kernels.reset_launch_counts()
    pair = r5.run(full, device)
    sat = r4.run(full, device)
    launches = dict(_kernels.launch_counts)
    r5.report(pair, device, "[studies] r5_pair64")
    r4.report(sat, device, "[studies] r4_saturation")
    log(f"[studies] launches in the two runs: {launches}")
    prod_full = pair["variants"]["prod"]["ms"]
    for name, variant in (("pair64_count", pair["variants"]["pair64"]),
                          ("nibble_count", pair["variants"]["nibble"])):
        log(f"[studies] {name} {variant['ms']:.3f} ms vs fused_count "
            f"{prod_full:.3f} ms on the banded chunk "
            f"({variant['ms'] / prod_full:.3f}x)")
    per_entry = pair["variants"]["nibble"]["chunks_per_entry"]
    log(f"[studies] full size: reach chunks a live entry, nibble "
        f"{per_entry['nibble']:.4f} (packed), fused_count "
        f"{per_entry['prod']:.4f} "
        f"({per_entry['nibble'] / per_entry['prod']:.4f} of its chunks)")
    staged = pair["variants"]["pair64"]["per_cta"]
    log(f"[studies] full size: a CTA stages, pair64 "
        f"{staged['pair64']['entries']:.3f} live entries and "
        f"{staged['pair64']['chunks']:.3f} reach chunks, fused_count "
        f"{staged['prod']['entries']:.3f} and {staged['prod']['chunks']:.3f}")
    log(f"[studies] builders vs build_jlist_banded: " + ", ".join(
        f"{k} {v['ms']:.3f} ms" for k, v in pair["builders"].items()))
    log(f"[studies] streamed j-atoms/atom: prod "
        f"{pair['variants']['prod']['j_atoms_per_atom']:.1f}, pair64 "
        f"{pair['variants']['pair64']['j_atoms_per_atom']:.1f}")
    prod_sat = sat["variants"]["prod"]["ms"]
    sat_bound = bound(sat["instr"], 0)[0]
    for ce in r4.CHECKS:
        v = sat["variants"][f"sat{ce}"]
        log(f"[studies] saturation_count check_every={ce} {v['ms']:.3f} ms vs "
            f"fused_count {prod_sat:.3f} ms on the host-cull chunk "
            f"({v['ms'] / prod_sat:.3f}x); skipped "
            f"{100 * v['skipped']:.3f} % of entries; "
            f"{sat_bound / v['ms']:.3f} of the {sat_bound:.4f} ms bound on "
            f"the work its inputs need")
    for result in (pair, sat):
        for name, v in result["variants"].items():
            if v["max_dcount"] != 0:
                raise AssertionError(f"full size: {name} differs from prod")
    if not pair["kernel_equal"]:
        raise AssertionError("full size: band_jlist differs from the plain "
                             "builder")
    for name in records:
        records[name]["launches"] = launches[name]
        if launches[name] == 0:
            raise AssertionError(f"{name} did not launch in the studies' runs")
    log(f"[studies] phase 8 took {time.perf_counter() - t_phase:.1f}s")
    return list(records.values())


def phase_count_studies_ii(corpus_dir, device, build_logs):
    """Phase 9: the count-kernel studies II.  The loop micro-variants and
    the reach-test kernel on a host-cull f32 corpus chunk (reach_count on
    the buried lattice block too), the max-plus kernel on the banded q16
    chunk of the same structures, each against
    its plain version for every variant and against fused_count; then the
    three studies' run() at full size, kernels only, with the launches of
    those runs.  Returns the three kernels' records."""
    import torch

    from rustsasa_tpu_torch.ops import _kernels, engine, fused_kernel as fk
    from rustsasa_tpu_torch.scripts import _study
    from rustsasa_tpu_torch.scripts import r3_kernel_variants as r3v
    from rustsasa_tpu_torch.scripts import r3_maxplus as r3m
    from rustsasa_tpu_torch.scripts import r4_microkernel as r4m
    from rustsasa_tpu_torch.scripts import r4_saturation as r4

    t_phase = time.perf_counter()
    sphere = engine._sphere_device(100, device)
    p = sphere.shape[0]
    passes, k = _kernels.point_passes(p)
    points = passes * _kernels.SLICES * k
    triples = _study.load_corpus(corpus_dir, slots=CHECK_CHUNK_SLOTS,
                                 max_tiles=r3m.W)
    planes, jl, real, atoms, tiles, failed = _study.host_cull_chunk(
        triples, device, CHECK_CHUNK_SLOTS)
    if failed:
        raise AssertionError(f"{failed} host j-lists overflowed")
    m = planes.shape[1]
    prod_ms, prod = cuda_ms(lambda: fk.fused_counts(planes, jl, sphere), 10)
    groups = r4m.streamed_groups(jl)
    log(f"[studies-ii] host-cull f32 chunk: {len(triples)} structures, "
        f"{atoms} atoms, {tiles} tiles in {m} slots; fused_count "
        f"{prod_ms:.3f} ms; all 16 groups of every live entry are "
        f"{groups['nosmem'] / max(groups['prod'], 1):.3f}x the admitted ones")
    records = {}
    work = fk.reach_work(planes, jl, sphere)
    (need_ms, _by), need_instr = kernel1_bound(work, m, sphere)
    lpasses, lk = _kernels.lane_passes(p)
    lpoints = lpasses * _kernels.COUNT_LANES * lk
    for variant in r4m.VARIANTS:
        ms, plain_ms, err, _ = _kernel_vs_plain(
            f"micro_count ({variant})",
            lambda v=variant: r4m.micro_counts(planes, jl, sphere, variant=v),
            lambda v=variant: r4m.micro_counts_reference(planes, jl, sphere,
                                                         variant=v),
            prod, real)
        own = count_bound(groups[variant] * 8 * 128 * lpoints, 7, m, p)
        held = own[0] if variant == "nosmem" else need_ms
        log(f"[studies-ii]   {ms / prod_ms:.3f}x fused_count on the same "
            f"chunk; {held / ms:.3f} of the bound on "
            + ("its own work (every row of every live entry)"
               if variant == "nosmem" else "the work its inputs need"))
        if variant == r4m.VARIANTS[0]:
            records["micro_count"] = dict(record(
                "micro_count", None, err, ms, plain_ms, prod_ms, own),
                variant=variant)
            recount_bound(records["micro_count"], "[studies-ii]", planes, jl,
                          sphere, work)
            redesigned_log(
                "[studies-ii]", build_logs["micro_count"],
                f"micro_count (prod, L={_kernels.COUNT_LANES}, K={lk}, "
                f"{lpasses} pass(es))", ms,
                (records["micro_count"]["bound_ms"],
                 records["micro_count"]["bound_by"]), need_instr,
                f"ILi{lk}ELi0E",
                K1_SMEM + 16 * lpasses * _kernels.COUNT_LANES * lk)
    lattice, lattice_jl = fk.to_device(r4.buried_block_wire(), device)
    lattice_prod = fk.fused_counts(lattice, lattice_jl, sphere)
    for variant in r3v.VARIANTS:
        ms, plain_ms, err, (_, executed) = _kernel_vs_plain(
            f"reach_count ({variant})",
            lambda v=variant: r3v.reach_counts(planes, jl, sphere, variant=v),
            lambda v=variant: r3v.reach_counts_reference(planes, jl, sphere,
                                                         variant=v),
            prod, real, equal_to_prod=variant in r3v.F32_VARIANTS)
        rows = int(executed.sum()) // passes
        log(f"[studies-ii]   {ms / prod_ms:.3f}x fused_count on the same "
            f"chunk; {need_ms / ms:.3f} of the bound on the work its inputs "
            f"need; {rows / max(int((jl[:, 0] > 0).sum()), 1):.1f} "
            f"j-atoms/atom executed, fused_count streams "
            f"{groups['prod'] * 8 / max(int((jl[:, 0] > 0).sum()), 1):.1f}")
        _kernel_vs_plain(
            f"reach_count ({variant}) on the buried lattice block",
            lambda v=variant: r3v.reach_counts(lattice, lattice_jl, sphere,
                                               variant=v),
            lambda v=variant: r3v.reach_counts_reference(
                lattice, lattice_jl, sphere, variant=v),
            lattice_prod, lattice[4] > 0.0,
            equal_to_prod=variant in r3v.F32_VARIANTS)
        if variant == r3v.VARIANTS[0]:
            records["reach_count"] = dict(record(
                "reach_count", None, err, ms, plain_ms, prod_ms,
                count_bound(rows * 128 * points, 7, m, p,
                            extra_out=4 * m // 128)),
                variant=variant)
            recount_bound(records["reach_count"], "[studies-ii]", planes, jl,
                          sphere, work)
            # The rule kernel alone (the launch's first kernel).
            rule_ms, (_, rule_executed) = cuda_ms(
                lambda: _kernels.reach_rule(planes, jl, sphere, variant), 10)
            if not torch.equal(rule_executed, executed):
                raise AssertionError("reach_rule's executed differs")
            log(f"[studies-ii]   reach_count's rule kernel alone "
                f"{rule_ms:.4f} ms of its {ms:.3f} ms")
            redesigned_log(
                "[studies-ii]", build_logs["reach_count"],
                f"reach_count (base, L={_kernels.COUNT_LANES}, K={lk}, "
                f"{lpasses} pass(es), rule kernel + count kernel)", ms,
                (records["reach_count"]["bound_ms"],
                 records["reach_count"]["bound_by"]), need_instr,
                f"reach_count_kernelILi{lk}ELi0E",
                REACH_SMEM + 16 * lpasses * _kernels.COUNT_LANES * lk)

    planes_q, qvalid, tmeta, real_q, _atoms, _tiles = _study.banded_chunk(
        triples, device, CHECK_CHUNK_SLOTS)
    jlist_q = fk.build_jlist_banded(planes_q, qvalid, tmeta, w=r3m.W)
    prod_q_ms, prod_q = cuda_ms(
        lambda: fk.fused_counts(planes_q, jlist_q, sphere), 10)
    log(f"[studies-ii] banded q16 chunk, w={r3m.W}: fused_count "
        f"{prod_q_ms:.3f} ms")
    ms, plain_ms, err, _ = _kernel_vs_plain(
        "maxplus_count (mp_static)",
        lambda: r3m.maxplus_counts(planes_q, jlist_q, sphere),
        lambda: r3m.maxplus_counts_reference(planes_q, jlist_q, sphere),
        prod_q, real_q, equal_to_prod=False)
    margins_q = int(_study.streamed_groups(jlist_q).sum()) // 2 * 8 * 128 * points
    records["maxplus_count"] = dict(record(
        "maxplus_count", None, err, ms, plain_ms, prod_q_ms,
        count_bound(margins_q, r3m.MAXPLUS_INSTR_PER_MARGIN, m, p)),
        variant="mp_static")
    recount_bound(records["maxplus_count"], "[studies-ii]", planes_q, jlist_q,
                  sphere)
    log(f"[studies-ii] maxplus_count at {margins_q * 2 / (ms * 1e-3) / 1e12:.2f}T "
        f"FP32 instr/s at its own work (2 per margin), fused_count at "
        f"{_study.k1_instructions(planes_q, jlist_q, sphere) / (prod_q_ms * 1e-3) / 1e12:.2f}T "
        f"at the work these inputs need (it streams only the rows in "
        f"reach; _study.k1_instructions)")
    mp_passes = -(-p // 128)
    mp_k = -(-p // (8 * mp_passes))
    # maxplus_count.cu's maxplus_smem: sphere, LIMT [16][2][128] float4,
    # TJ [8K][136], two j-tiles, the j-list row and the counters.
    mp_smem = (16 * (mp_passes * 8 * mp_k + 16 * 2 * 128)
               + 4 * (8 * mp_k * 136 + 2 * 5 * 128) + 4 * 2 * 128)
    redesigned_log("[studies-ii]", build_logs["maxplus_count"],
                   f"maxplus_count (P={p}: {mp_passes} pass(es) of 8 x "
                   f"K={mp_k})", ms, (records["maxplus_count"]["bound_ms"],
                                      records["maxplus_count"]["bound_by"]),
                   margins_q * r3m.MAXPLUS_INSTR_PER_MARGIN, f"ILi{mp_k}E",
                   mp_smem)

    # Full size: the studies' own entry, kernels only.
    t0 = time.perf_counter()
    full = _study.load_corpus(corpus_dir, max_tiles=r3m.W)
    log(f"[studies-ii] full-size chunk: {len(full)} structures selected in "
        f"{time.perf_counter() - t0:.1f}s")
    _kernels.reset_launch_counts()
    micro = r4m.run(full, device)
    reach = r3v.run(full, device)
    with SmClocks() as clocks:
        maxplus = r3m.run(full, device)
    launches = dict(_kernels.launch_counts)
    log(f"[studies-ii] during r3_maxplus.run(): {clocks.summary()}")
    r4m.report(micro, device, "[studies-ii] r4_microkernel")
    k1_full = micro["variants"]["k1"]["ms"]
    for name in r4m.VARIANTS:
        v = micro["variants"][name]
        own = bound(v["instr"], 0)[0]
        log(f"[studies-ii] micro_count ({name}) at 2M {v['ms']:.3f} ms, "
            f"{v['ms'] / k1_full:.3f}x fused_count, {own / v['ms']:.3f} of "
            f"the {own:.4f} ms bound on "
            + ("its own work" if name == "nosmem"
               else "the work its inputs need"))
    r3v.report(reach, device, "[studies-ii] r3_kernel_variants")
    k1_reach = reach["variants"]["k1"]["ms"]
    for name in r3v.VARIANTS:
        v = reach["variants"][name]
        log(f"[studies-ii] reach_count ({name}) at 2M {v['ms']:.3f} ms, "
            f"{v['ms'] / k1_reach:.3f}x fused_count, "
            f"{bound(v['instr'], 0)[0] / v['ms']:.3f} of the "
            f"{bound(v['instr'], 0)[0]:.4f} ms bound on the work its inputs "
            f"need")
    r3m.report(maxplus, device, "[studies-ii] r3_maxplus")
    log(f"[studies-ii] launches in the three runs: {launches}")
    for result, exact in ((micro, r4m.VARIANTS), (reach, r3v.F32_VARIANTS)):
        for name in exact:
            if result["variants"][name]["max_dcount"] != 0:
                raise AssertionError(f"full size: {name} differs from k1")
    for name in records:
        records[name]["launches"] = launches[name]
        if launches[name] == 0:
            raise AssertionError(f"{name} did not launch in the studies' runs")
    log(f"[studies-ii] phase 9 took {time.perf_counter() - t_phase:.1f}s")
    return list(records.values())


def ke_bound(ke, variant, t, nj, executed):
    """bound() of a kernel-experiment variant over t tiles and nj j-rows
    whose tiles ran `executed` 8-row groups: its FP32 (or packed bf16)
    instructions on the margins its work needs at the issue peak, at
    DEFAULT also the mma work at the bf16 tensor-core peak, and its bytes
    (sphere, planes rows 0-4, j-data and the outputs once) at HBM
    bandwidth."""
    margins = ke.needed_margins(variant, t, executed)
    m = t * ke.A
    nbytes = 16 * ke.P + 4 * 5 * m + 32 * nj + 4 * m + 4 * t
    ms, by = bound(ke.instr_per_margin(variant) * margins, nbytes)
    family, params = ke.VARIANTS[variant]
    if params.get("default"):
        # mma m16n8k16 with K = 16: 2 * 16 flops per output element; per
        # j-row and tile the mxu dots have P x A outputs, the max-plus
        # products P.
        outputs = ke.P * ke.A if family == "mxu" else ke.P
        flops = 2 * 16 * outputs * executed * ke.GROUP
        tc_ms = flops / BF16_TC_FLOPS * 1e3
        if tc_ms > ms:
            ms, by = tc_ms, "operations"
    return ms, by


def ke_redesigned(ke, variant, nj):
    """(part of the mangled kernel name, shared memory bytes) of a
    ke_maxplus.cu or ke_bf16.cu variant at nj j-rows (the template flags
    of its launcher's case, and ke_common.cuh's base_smem plus the
    source's own buffers), or of ke_stream.cu's nobig and noscalar
    kernels."""
    from rustsasa_tpu_torch.ops import _kernels

    source = ke.source(variant)
    if variant == "nobig":
        # The staged j-rows (x, y, z, r*r and the gid) and the 8 j-slices'
        # maxima, [8][128].
        return "ke_nobig_kernel", 20 * nj + 4 * 8 * ke.A
    if variant == "noscalar":
        return "ke_noscalar_kernel", 16 * ke.P  # the sphere (static)
    code = _kernels.KE_VARIANTS[source].index(variant)
    base = 16 * ke.P + 4 * (7 * ke.A + max(nj * 8, ke.P * ke.A))
    if source == "ke_bf16":
        # Two ring slots of [8 rows][4 quantities][128 atoms] words.
        return f"ke_bf16_kernelILb{code}EE", base + 4 * 2 * 4 * ke.GROUP * ke.A
    # (per_tile, DEFAULT, skip, sat) of ke_maxplus_launch's cases.
    flags = ((1, 0, 0, 0), (1, 1, 0, 0), (1, 0, 1, 0), (0, 0, 0, 0),
             (0, 1, 0, 0), (1, 0, 0, 1))[code]
    # The j-tile's limits [128][128], each of 16 warps' SXJ ([128 or
    # 2 x 8 j][8 points]) and 16 votes.
    smem = base + 4 * (128 * ke.A + 16 * (128 if flags[0] else 16) * 8) + 64
    return "ke_maxplus_kernelI" + "".join(f"Lb{f}E" for f in flags) + "E", smem


def phase_kernel_experiments(device, build_logs):
    """Phase 10: the kernel experiments.  Every variant against its plain
    version at KE_CHECK_TILES tiles x NJ j-rows on the script's ones and on
    the seeded random j-data (kernel and plain timed on the ones), then
    kernel_experiments.run() at the script's T x NJ, whose launches are the
    four sources' launch counts.  Returns the four sources' records, each
    for the source's first variant, and one for mxu_dots_def."""
    import torch

    from rustsasa_tpu_torch.ops import _kernels
    from rustsasa_tpu_torch.scripts import kernel_experiments as ke

    t_phase = time.perf_counter()
    t, nj = KE_CHECK_TILES, ke.NJ
    errs = {variant: 0.0 for variant in ke.VARIANTS}
    check_ms = {}
    for jdata in ("ones", "random"):
        sphere, planes, jd = ke.synthetic_inputs(t, nj, device, jdata)
        for variant in ke.VARIANTS:
            def kernel(v=variant):
                return ke.experiment(v, sphere, planes, jd)

            def plain(v=variant):
                return ke.experiment_reference(planes, v, sphere, jd)

            if jdata == "ones":
                ms, got = cuda_ms(kernel, 5)
                plain_ms, want = cuda_ms(plain, 1)
                check_ms[variant] = (ms, plain_ms)
            else:
                got, want = kernel(), plain()
                torch.cuda.synchronize()
            err, ok = ke.agreement(variant, sphere, planes, jd, got, want)
            errs[variant] = max(errs[variant], err)
            groups = t * (ke.jrows(variant, nj) // ke.GROUP)
            ran = int(got[1].sum())
            held = ("within the DEFAULT bound"
                    if ke.VARIANTS[variant][1].get("default") else "byte-equal")
            log(f"[ke] {jdata:6s} {variant:17s} max |kernel - plain| {err:.6g}"
                f" ({held}: {ok}); groups skipped {groups - ran} of {groups} "
                f"({100 * (groups - ran) / max(groups, 1):.2f} %)"
                + (f"; {check_ms[variant][0]:.3f} ms, plain torch "
                   f"{check_ms[variant][1]:.3f} ms" if jdata == "ones" else ""))
            if not ok or not bool(torch.isfinite(got[0]).all()):
                raise AssertionError(f"{variant} ({jdata}): kernel disagrees "
                                     f"with its plain version")

    _kernels.reset_launch_counts()
    with SmClocks() as clocks:
        result = ke.run(device)
    launches = dict(_kernels.launch_counts)
    log(f"[ke] during kernel_experiments.run(): {clocks.summary()}")
    ke.report(result, device, "[ke] kernel_experiments")
    full_t, full_nj = result["t"], result["nj"]
    for variant, v in result["variants"].items():
        bound_ms, by = ke_bound(ke, variant, full_t, full_nj, v["executed"])
        log(f"[ke] {variant:17s} T={full_t}: {v['ms']:.3f} ms, "
            f"{v['ns_per_jatom']:.4f} ns/j-atom, bound {bound_ms:.3f} ms "
            f"({by}; {bound_ms / v['ms']:.3f} of it); T={t}: "
            f"{check_ms[variant][0]:.3f} ms, plain {check_ms[variant][1]:.3f} ms")
    log(f"[ke] launches in run(): {launches}")
    v = result["variants"]["mxu_dots_def"]
    region = max(full_nj * 8, ke.P * ke.A)
    # ke_common.cuh's base_smem plus ke_mxu.cu's kDefExtra (the sphere as
    # B, 4096 B; two group slots of [3][8][128] words).
    def_smem = (16 * ke.P + 4 * (7 * ke.A + region) + 4096
                + 4 * 2 * 3 * ke.GROUP * ke.A)
    redesigned_log("[ke]", build_logs["ke_mxu"],
                   f"mxu_dots_def (wgmma, T={full_t})",
                   v["ms"], ke_bound(ke, "mxu_dots_def", full_t, full_nj,
                                     v["executed"]),
                   v["instr_per_margin"] * v["margins"], "ke_mxu_def_kernel",
                   def_smem)
    for variant in (*_kernels.KE_VARIANTS["ke_maxplus"],
                    *_kernels.KE_VARIANTS["ke_bf16"], "nobig", "noscalar"):
        v = result["variants"][variant]
        fn_part, smem = ke_redesigned(ke, variant, full_nj)
        redesigned_log("[ke]", build_logs[ke.source(variant)],
                       f"{variant} (T={full_t})", v["ms"],
                       ke_bound(ke, variant, full_t, full_nj, v["executed"]),
                       v["instr_per_margin"] * v["margins"], fn_part, smem)
    records = []
    sphere, planes, jd = ke.synthetic_inputs(full_t, full_nj, device)
    for name, variant in [(name, variants[0]) for name, variants
                          in _kernels.KE_VARIANTS.items()] + [
                              ("ke_mxu_def", "mxu_dots_def")]:
        v = result["variants"][variant]
        plain_ms, _ = cuda_ms(
            lambda: ke.experiment_reference(planes, variant, sphere, jd), 1)
        source = ke.source(variant)
        if launches[source] == 0:
            raise AssertionError(f"{source} did not launch in run()")
        records.append(dict(
            record(name, launches[source], errs[variant], v["ms"], plain_ms,
                   None, ke_bound(ke, variant, full_t, full_nj, v["executed"])),
            variant=variant))
    log(f"[ke] phase 10 took {time.perf_counter() - t_phase:.1f}s")
    return records


# Runs `python -m rustsasa_tpu_torch.cli` (runpy, as -m does) with the
# arguments given, and prints the kernels' launch counts of that process
# to stderr when it ends.
CLI_RUNNER = """
import json, runpy, sys
from rustsasa_tpu_torch.ops import _kernels
try:
    runpy.run_module('rustsasa_tpu_torch.cli', run_name='__main__',
                     alter_sys=True)
finally:
    print('LAUNCHES ' + json.dumps(_kernels.launch_counts), file=sys.stderr)
"""


def run_cli(args, tag):
    """One CLI process; returns (wall seconds, its launch counts)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_RUNNER, *args], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
    )
    wall = time.perf_counter() - t0
    counts = [line for line in proc.stderr.splitlines()
              if line.startswith("LAUNCHES ")]
    if proc.returncode != 0 or not counts:
        raise AssertionError(f"CLI {tag} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    launches = json.loads(counts[-1].split(" ", 1)[1])
    log(f"[cli] {tag}: {wall:.3f}s wall (process start included), "
        f"{launches['fused_count']} fused_count, "
        f"{launches['list_occlusion']} list_occlusion, "
        f"{launches['cell_keys']} cell_keys and "
        f"{launches['neighbor_cells']} neighbor_cells launches")
    if not (launches["neighbor_cells"] == launches["cell_keys"]
            == launches["list_occlusion"]):
        raise AssertionError(f"CLI {tag}: launches {launches}")
    return wall, launches


def phase_cli(smi):
    """`python -m rustsasa_tpu_torch.cli` on example.cif with --device
    cuda and --device cpu (every value within 1e-3), over the 88 FreeSASA
    files in directory mode, and with -T on a 16-frame DCD."""
    from rustsasa_tpu_torch.benches.md_trajectory import jitter_frames
    from rustsasa_tpu_torch.trajectory import write_dcd

    work = os.path.join(WORK, "cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    docs, raw = {}, {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(work, f"example_{dev}.json")
        _, launches = run_cli([EXAMPLE, out, "--output-depth", "residue",
                               "--device", dev], f"example.cif --device {dev}")
        if launches["fused_count"] != (1 if dev == "cuda" else 0):
            raise AssertionError(f"--device {dev}: launches {launches}")
        with open(out, "rb") as f:
            raw[dev] = f.read()
        docs[dev] = json.loads(raw[dev])["Residue"]
    if len(docs["cuda"]) != len(docs["cpu"]) or not docs["cpu"]:
        raise AssertionError("cuda and cpu residue counts differ")
    worst, first = 0.0, None
    for got, want in zip(docs["cuda"], docs["cpu"]):
        if {k: v for k, v in got.items() if k != "value"} != {
                k: v for k, v in want.items() if k != "value"}:
            raise AssertionError(f"residue fields differ: {got} {want}")
        diff = abs(got["value"] - want["value"])
        worst = max(worst, diff)
        if diff and first is None:
            first = (got, want)
    log(f"[cli] example.cif residue JSON: {len(docs['cpu'])} residues, max "
        f"|cuda - cpu| {worst:.6g} (limit 1e-3); files byte-equal: "
        f"{raw['cuda'] == raw['cpu']}"
        + (f"; first differing value {first}" if first else ""))
    if not worst <= 1e-3:
        raise AssertionError(f"cuda and cpu differ by {worst}")

    out_dir = os.path.join(work, "freesasa_out")
    _, launches = run_cli([SOURCE_DIR, out_dir, "--format", "json",
                           "--device", "cuda"], "88 FreeSASA files, directory")
    n_out = len(os.listdir(out_dir))
    if n_out != len(os.listdir(SOURCE_DIR)) or not launches["fused_count"] or (
            not launches["list_occlusion"]):
        raise AssertionError(f"directory mode: {n_out} outputs, {launches}")

    dcd = os.path.join(work, "traj16.dcd")
    write_dcd(dcd, jitter_frames(EXAMPLE, 16))
    out = os.path.join(work, "traj16.json")
    _, launches = run_cli([dcd, out, "-T", EXAMPLE, "--device", "cuda"],
                          "-T example.cif, 16 frames")
    with open(out, encoding="utf-8") as f:
        doc = json.load(f)
    if doc["n_frames"] != 16 or len(doc["residues"]) != 16 or not all(
            math.isfinite(v) and v > 0 for v in doc["totals"]):
        raise AssertionError(f"-T output: {doc['n_frames']} frames")
    if launches["fused_count"] != 1:
        raise AssertionError(f"-T launches {launches}")
    log(f"[cli] -T: {doc['n_frames']} frames, totals {min(doc['totals']):.1f}"
        f"-{max(doc['totals']):.1f}; times beside {smi}")


def phase_trajectory(device, smi):
    """example.cif x 2,500 jittered frames (the MD bench's workload):
    three frames byte-equal to calculate_sasa_internal on the card, one
    within 1e-3 of the CPU's plain path."""
    import numpy as np

    from rustsasa_tpu_torch import (
        Level, SASAOptions, calculate_sasa_internal, read_structure,
    )
    from rustsasa_tpu_torch.benches import md_trajectory
    from rustsasa_tpu_torch.levels import _residue_sums
    from rustsasa_tpu_torch.ops import _kernels
    from rustsasa_tpu_torch.trajectory import read_dcd

    n_frames = md_trajectory.N_FRAMES
    dcd = os.path.join(WORK, "traj.dcd")
    _kernels.reset_launch_counts()
    record = md_trajectory.run(EXAMPLE, n_frames, "cuda", dcd_path=dcd,
                               say=lambda msg: log(f"[traj] {msg}"))
    launches = dict(_kernels.launch_counts)
    result = record.pop("result")
    log(f"[traj] {json.dumps(record)}")
    log(f"[traj] launches over the warm and the timed pass: {launches}")
    if result.n_frames != n_frames or result.residue_values.shape[0] != (
            n_frames) or not launches["fused_count"]:
        raise AssertionError(f"{result.n_frames} frames, {launches}")
    _, frames = read_dcd(dcd)
    opts = SASAOptions(level=Level.RESIDUE)
    sel = opts.build_selection(read_structure(EXAMPLE))

    def frame_sasa(f, dev):
        return calculate_sasa_internal(
            frames[f][sel.atom_indices], sel.radii, group_ids=sel.group_ids,
            device=dev)

    for f in (0, n_frames // 2, n_frames - 1):
        atom_sasa = frame_sasa(f, device)
        if not (result.totals[f] == np.float32(float(atom_sasa.sum()))
                and np.array_equal(result.residue_values[f],
                                   _residue_sums(sel, atom_sasa))):
            raise AssertionError(f"frame {f} differs from "
                                 f"calculate_sasa_internal")
    cpu = _residue_sums(sel, frame_sasa(0, "cpu"))
    err = float(np.abs(result.residue_values[0] - cpu).max())
    log(f"[traj] frames 0, {n_frames // 2}, {n_frames - 1} byte-equal to "
        f"calculate_sasa_internal on the card; frame 0 residues within "
        f"{err:.6g} of the CPU's plain path (limit 1e-3); {smi}")
    if not err <= 1e-3:
        raise AssertionError(f"frame 0 vs CPU: {err}")


def phase_quality_gate(device, smi):
    """The port's FreeSASA gate on the card: four depths and the
    occupancy row, 88/88 files each, every row passing."""
    from rustsasa_tpu_torch.ops import _kernels
    from rustsasa_tpu_torch.scripts import quality_gate

    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = quality_gate.run_gate(device)
    elapsed = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    quality_gate.write_artifact(result, os.path.join(WORK,
                                                     "quality_latest.json"))
    for row in result["rows"]:
        log(f"[gate] {row['depth']:17s} rmse {row['rmse']} pearson_r "
            f"{row['pearson_r']} n={row['n']} {row['n_ok']}/{row['n_files']} "
            f"files pass={row['pass']}")
    log(f"[gate] residue rmse {result['rmse']} against the JAX package's "
        f"{REFERENCE_RESIDUE_RMSE} (BENCH_r05.json): gap "
        f"{result['rmse'] - REFERENCE_RESIDUE_RMSE:+.4f}; {elapsed:.1f}s; "
        f"launches {launches}; {smi}")
    n = len(os.listdir(SOURCE_DIR))
    if not result["pass"] or any(
            not row["pass"] or row["n_ok"] != row["n_files"] or row["n_files"]
            != n for row in result["rows"]):
        raise AssertionError("the quality gate failed")
    if not launches["fused_count"] or not launches["list_occlusion"] or (
            launches["neighbor_cells"] != launches["list_occlusion"]) or (
            launches["cell_keys"] != launches["list_occlusion"]):
        raise AssertionError(f"gate launches {launches}")


def phase_scale_out(device, corpus_dir, main_median, smi):
    """Phase 14: the scale-out layer on one card.  The corpus through an
    engine on two streams of the card, byte-equal to phase 4's last pass;
    two Gloo ranks on the card over the same corpus; the sharded list
    step on FreeSASA structures against the unsharded one; the
    multi-device dry run.  Returns {kernel: {path: launches}}."""
    import numpy as np
    import torch

    from rustsasa_tpu_torch import (
        BatchedSasaEngine, Level, SASAOptions, SasaParams, graft_entry,
        process_directory,
    )
    from rustsasa_tpu_torch.ops import _kernels, engine, neighbors
    from rustsasa_tpu_torch.parallel import mesh
    from rustsasa_tpu_torch.parallel.worker import run_workers
    from rustsasa_tpu_torch.scripts._study import select
    from rustsasa_tpu_torch.scripts.scaling_curve import read_outputs

    t_phase = time.perf_counter()
    work = os.path.join(WORK, "scale_out")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    one = read_outputs(os.path.join(WORK, "out"))  # phase 4's last pass
    n_files = len(os.listdir(corpus_dir))
    if len(one) != n_files:
        raise AssertionError(f"phase 4 left {len(one)} outputs")
    launches = {"fused_count": {}, **{k: {} for k in LIST_KERNELS},
                **{k: {} for k in BAND_KERNELS}}

    # 1. Device list: chunks dealt to two streams of the card.
    options = SASAOptions(level=Level.RESIDUE)
    walls = []
    for _ in range(2):
        out_dir = os.path.join(work, "two_streams")
        shutil.rmtree(out_dir, ignore_errors=True)
        eng = BatchedSasaEngine(SasaParams(), devices=[device, device])
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rep = process_directory(corpus_dir, out_dir, options, "json",
                                progress=False, engine=eng)
        walls.append(time.perf_counter() - t0)
        n_launch = _kernels.launch_counts["fused_count"]
        band = {k: _kernels.launch_counts[k] for k in BAND_KERNELS}
    entries = eng.routes.entries
    routes = eng.routes.counts
    log(f"[scale-out] two streams on {device}: {rep.n_ok}/{rep.n_files} "
        f"files in {walls[0]:.3f}s, then {walls[1]:.3f}s (phase 4's "
        f"one-stream median {main_median:.3f}s); chunks per entry "
        f"{entries}, {n_launch} fused_count launches; {smi}")
    if rep.n_ok != n_files or rep.errors:
        raise AssertionError(f"two streams: {rep.n_ok}/{n_files} ok")
    if min(entries) < 1 or sum(entries) != n_launch or (
            n_launch != eng.chunks_dispatched):
        raise AssertionError(f"entries {entries}, {n_launch} launches")
    if read_outputs(out_dir) != one:
        raise AssertionError("two streams: outputs differ from one stream")
    banded = routes["q13"] + routes["q16"]
    if band != {"dequant_boxes": banded + routes["host_q16"],
                "band_jlist": banded}:
        raise AssertionError(f"two streams: {band} for routes {routes}")
    launches["fused_count"]["two_streams"] = n_launch
    for k in BAND_KERNELS:
        launches[k]["two_streams"] = band[k]
    log(f"[scale-out] two-stream outputs byte-equal to phase 4's "
        f"one-stream pass ({n_files} files)")

    # 2. Two Gloo ranks on the card.  They are processes of their own:
    # first hand back what this process's allocator keeps cached from the
    # earlier phases (it held 79 of the card's 80 GB here).
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    out_dir = os.path.join(work, "two_ranks")
    reports, wall = run_workers(2, corpus_dir, out_dir,
                                os.path.join(work, "reports"),
                                device=device.type, timeout=600)
    shared = [(r["n_files"], r["n_ok"], r["n_errors"], r["total_area"])
              for r in reports]
    rank_launches = [r["launches"]["fused_count"] for r in reports]
    log(f"[scale-out] two ranks ({', '.join(r['device'] for r in reports)})"
        f": {wall:.3f}s wall from the first start to the last exit, "
        f"{[round(r['elapsed_s'], 3) for r in reports]} s to the final "
        f"all-reduce, own shard times "
        f"{[round(r['shard_s'], 3) for r in reports]} s; reports "
        f"{shared}; fused_count launches per rank {rank_launches}; "
        f"os.cpu_count() {os.cpu_count()}; {smi}")
    if shared[0] != shared[1] or shared[0][:3] != (n_files, n_files, 0):
        raise AssertionError(f"two ranks: reports {shared}")
    if min(rank_launches) < 1:
        raise AssertionError(f"two ranks: launches {rank_launches}")
    if read_outputs(out_dir) != one:
        raise AssertionError("two ranks: outputs differ from one process")
    launches["fused_count"]["two_ranks"] = sum(rank_launches)
    for k in BAND_KERNELS:
        launches[k]["two_ranks"] = sum(r["launches"][k] for r in reports)
    log(f"[scale-out] every input written once by the two ranks, "
        f"byte-equal to one process")

    # 3. The sharded list step on real proteins of one N bucket.
    buckets = {}
    for name in sorted(os.listdir(SOURCE_DIR)):
        triple = select(os.path.join(SOURCE_DIR, name))
        n_pad = neighbors._round_bucket(triple[0].shape[0],
                                        neighbors._N_BUCKETS)
        buckets.setdefault(n_pad, []).append(triple)
    n_pad, members = max(buckets.items(), key=lambda kv: len(kv[1]))
    b = min(len(members), engine._batch_cap(n_pad)) // 2 * 2
    if b < 2:
        raise AssertionError(f"no two structures share an N bucket")
    packed, gid = engine._pack(n_pad, members[:b])
    sphere = engine._sphere_packed(100)
    devices = [device, device]
    k = neighbors._initial_k(n_pad)
    runs = 0
    while True:
        step = mesh.make_sharded_sasa(devices, k=k, n_points=100, probe=PROBE)
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        sasa, total, max_count = step(packed, gid, sphere)
        mc = int(max_count[0])  # a readback: waits for the step
        step_s = time.perf_counter() - t0
        n_launch = _kernels.launch_counts["list_occlusion"]
        runs += 1
        if n_launch != len(devices) or any(
                _kernels.launch_counts[k] != len(devices)
                for k in LIST_KERNELS):
            raise AssertionError(f"sharded step: launches "
                                 f"{_kernels.launch_counts}")
        if mc <= k:
            break
        k = min(neighbors._round_bucket(mc, neighbors._K_BUCKETS), n_pad)
    whole, whole_mc = neighbors._sasa_batched(
        *(torch.from_numpy(a).to(device) for a in (packed, gid, sphere)),
        k=k, n_points=100, probe=PROBE)
    equal = bool(torch.equal(sasa, whole))
    want_total = float(whole.double().sum())
    log(f"[scale-out] sharded list step: {b} FreeSASA structures padded to "
        f"N={n_pad}, K={k} after {runs} run(s) (max candidates {mc}), "
        f"{len(devices)} shards on {device}: {step_s * 1e3:.1f} ms (host "
        f"clock), total {float(total[0]):.3f} A^2; byte-equal to "
        f"_sasa_batched on the whole batch: {equal}; total equals its sum: "
        f"{float(total[0]) == want_total}; list_occlusion, cell_keys and "
        f"neighbor_cells launches {n_launch} each")
    if not equal or float(total[0]) != want_total or mc != int(whole_mc):
        raise AssertionError("sharded list step differs from unsharded")
    if not bool(torch.isfinite(sasa).all()) or not want_total > 0.0:
        raise AssertionError("sharded list step: no surface")
    for k in LIST_KERNELS:
        launches[k]["sharded"] = n_launch

    # 4. The multi-device dry run over the same two entries.
    _kernels.reset_launch_counts()
    graft_entry.dryrun_multichip(devices)
    dry = dict(_kernels.launch_counts)
    log(f"[scale-out] dryrun_multichip({devices}) passed; launches "
        f"fused_count {dry['fused_count']}, list_occlusion "
        f"{dry['list_occlusion']}, cell_keys {dry['cell_keys']}, "
        f"neighbor_cells {dry['neighbor_cells']}")
    if dry["fused_count"] != len(devices) or any(
            dry[k] != len(devices) for k in LIST_KERNELS):
        raise AssertionError(f"dryrun launches {dry}")
    launches["fused_count"]["dryrun"] = dry["fused_count"]
    for k in BAND_KERNELS:
        launches[k]["dryrun"] = dry[k]
    for k in LIST_KERNELS:
        launches[k]["dryrun"] = dry[k]
    log(f"[scale-out] phase 14 took {time.perf_counter() - t_phase:.1f}s")
    return launches


def phase_profilers(device, corpus_dir, smi):
    """Phase 15: the profilers and studies ported last, each through its
    run() at the reference script's size on "cuda", with kernel 1's
    launches counted from 0 around each; then kernel 1 against its plain
    version on q12 planes and atombox j-lists, inputs no earlier phase
    feeds it.  Returns {kernel: {path: launches}} for the main path's
    three kernels."""
    import numpy as np
    import torch

    from rustsasa_tpu_torch.benches import micro_bench
    from rustsasa_tpu_torch.ops import _kernels, engine, fused_kernel as fk
    from rustsasa_tpu_torch.scripts import (
        _study, profile_fused, profile_native_pipeline, profile_pipeline,
        r4_atombox, r4_cull_granularity, r5_qwire, r5_spherecull,
    )

    t_phase = time.perf_counter()
    launches = {}
    band = {k: {} for k in BAND_KERNELS}

    def counted(path, fn):
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        launches[path] = _kernels.launch_counts["fused_count"]
        for k in BAND_KERNELS:
            band[k][path] = _kernels.launch_counts[k]
        log(f"[profilers] {path}: {time.perf_counter() - t0:.1f}s, "
            f"{launches[path]} fused_count launches, "
            + ", ".join(f"{band[k][path]} {k}" for k in BAND_KERNELS))
        return result

    def show(path, lines):
        for line in lines:
            log(f"[profilers] {path}: {line}")
        log(f"[profilers] {path}: {smi}")

    def finite(path, result, keys):
        bad = [k for k in keys if not (np.isfinite(result[k])
                                       and result[k] > 0)]
        if bad:
            raise AssertionError(f"{path}: stage figures {bad} not positive")

    r = counted("profile_native_pipeline", lambda: profile_native_pipeline.run(
        corpus_dir, device="cuda",
        out_dir=os.path.join(WORK, "profile_native_out")))
    show("profile_native_pipeline", profile_native_pipeline.lines(r))
    finite("profile_native_pipeline", r,
           ("load_s", "pack_s", "device_s", "device2_s", "emit_s", "atoms"))
    if r["files"] != profile_native_pipeline.LIMIT:
        raise AssertionError(f"profile_native_pipeline: {r['files']} files")

    r = counted("profile_pipeline", lambda: profile_pipeline.run(
        corpus_dir, device="cuda",
        out_dir=os.path.join(WORK, "profile_python_out")))
    show("profile_pipeline", profile_pipeline.lines(r))
    finite("profile_pipeline", r, ("parse_s", "select_s", "pack_s",
                                   "device_s", "device2_s", "emit_s"))

    r = counted("profile_fused", lambda: profile_fused.run(
        corpus_dir, device="cuda"))
    show("profile_fused", profile_fused.lines(r))
    finite("profile_fused", r, ("ms", "fp32_instr_per_s", "matoms_s"))
    if r["failed"] or not (np.isfinite(r["sasa"]).all()
                           and r["sasa"].sum() > 0):
        raise AssertionError("profile_fused: no valid areas")

    r = counted("micro_bench", lambda: micro_bench.run(EXAMPLE,
                                                       device="cuda"))
    show("micro_bench", [f"{k:32s} {v:10.3f} ms"
                         for k, v in r["units_ms"].items()])

    r = counted("r4_atombox", lambda: r4_atombox.run(corpus_dir,
                                                     device="cuda"))
    show("r4_atombox", r4_atombox.lines(r))
    if not (r["jlists_equal"] and r["counts_equal"]):
        raise AssertionError("r4_atombox: the two rows differ")

    r = counted("r5_qwire", lambda: r5_qwire.run(corpus_dir, device="cuda"))
    show("r5_qwire", r5_qwire.lines(r))
    if not r["r_eff_exact"]:
        raise AssertionError("r5_qwire: q12 r_eff not bit-equal")

    for study in (r4_cull_granularity, r5_spherecull):
        name = study.__name__.rsplit(".", 1)[1]
        r = counted(name, lambda: study.run(corpus_dir))
        show(name, r["lines"])
        if launches.pop(name) or any(band[k].pop(name) for k in band):
            raise AssertionError(f"{name} launched a kernel")

    # Kernel 1 on the studies' inputs, against its plain version.
    triples = _study.load_corpus(corpus_dir, slots=CHECK_CHUNK_SLOTS,
                                 max_tiles=r4_atombox.W)
    sphere = engine._sphere_device(100, device)
    *q12, offsets = r5_qwire.pack_q12(triples, PROBE)
    planes, qvalid = r5_qwire.dequant_q12(*fk.to_device(q12[:4], device))
    tmeta = fk.to_device(q12[4:], device)[0]
    checks = [("q12 planes", planes,
               fk.build_jlist_banded(planes, qvalid, tmeta, w=32), offsets)]
    planes4, tparams, tmeta, offsets = fk.pack_structures_q16(triples, PROBE)
    jlist, planes = r4_atombox.build_only(
        *fk.to_device((planes4, tparams, tmeta), device), w=32,
        fine="atombox")
    checks.append(("atombox j-lists", planes, jlist, offsets))
    for name, planes, jlist, offsets in checks:
        kernel_ms, got = cuda_ms(lambda: fk.fused_counts(planes, jlist,
                                                         sphere), 3)
        plain_ms, want = cuda_ms(
            lambda: fk.fused_counts_reference(planes, jlist, sphere), 1,
            warm=False)
        real = _study.real_slots(offsets, planes.shape[1], device)
        diff = int((got.to(torch.int64) - want.to(torch.int64)).abs()[real]
                   .max())
        m = planes.shape[1]
        k1_bound = kernel1_bound(fk.reach_work(planes, jlist, sphere), m,
                                 sphere)[0]
        old_bound = count_bound(
            int(_study.streamed_groups(jlist).sum()) // 2 * 8 * 128
            * sphere.shape[0], 7, m, sphere.shape[0])
        log(f"[profilers] fused_count on {name}: {len(triples)} structures, "
            f"{m} slots; {kernel_ms:.3f} ms, plain torch {plain_ms:.3f} ms; "
            f"max |diff| at real slots {diff}; bound {k1_bound[0]:.4f} ms on "
            f"the work these inputs need ({k1_bound[0] / kernel_ms:.3f} of "
            f"it), {old_bound[0]:.3f} ms on every admitted margin; {smi}")
        if diff:
            raise AssertionError(f"fused_count differs from plain on {name}")
    idle = [path for path, n in launches.items() if not n]
    if idle:
        raise AssertionError(f"fused_count did not launch in {idle}")
    log(f"[profilers] phase 15 took {time.perf_counter() - t_phase:.1f}s")
    return {"fused_count": launches, **band}


def phase_tools(device, corpus_dir, smi):
    """Phase 16: the reference's last tools on the card -
    `BatchedSasaEngine.warm_shapes` (each kernel launched once a shape),
    r3_link_floor, r3_split (its end-to-end counts byte-equal to its
    kernels-alone run and to the engine's) and `precompile_fused --quick`
    in a process of its own (its shapes' first launches are that
    process's).  Returns {kernel: {path: launches}} for the main path's
    three kernels."""
    from rustsasa_tpu_torch.ops import _kernels, engine
    from rustsasa_tpu_torch.scripts import r3_link_floor, r3_split

    t_phase = time.perf_counter()
    names = (*BAND_KERNELS, "fused_count")
    launches = {k: {} for k in names}

    def counted(path, fn):
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        for k in names:
            launches[k][path] = _kernels.launch_counts[k]
        log(f"[tools] {path}: {time.perf_counter() - t0:.1f}s, launches "
            + ", ".join(f"{launches[k][path]} {k}" for k in names))
        return result

    eng = engine.BatchedSasaEngine(engine.SasaParams(), device=device)
    shapes = eng._WARM_SHAPES
    elapsed = counted("warm_shapes", eng.warm_shapes)
    log(f"[tools] warm_shapes: {len(shapes)} shapes on {len(eng.ring)} "
        f"entry, one thread a shape, {elapsed:.4f}s (the kernels already "
        f"launched by the earlier phases); {smi}")
    if any(launches[k]["warm_shapes"] != len(shapes) for k in names):
        raise AssertionError(f"warm_shapes launches {launches}")

    r = counted("r3_link_floor", lambda: r3_link_floor.run(device))
    log(f"[tools] r3_link_floor: {json.dumps(r)}")
    if not all(r[k] > 0 for k in ("dispatch_floor_median_ms",
                                  "h2d_64mb_pinned_mbps",
                                  "d2h_64mb_pinned_mbps",
                                  "fused_single_protein_device_median_ms")):
        raise AssertionError("r3_link_floor: a figure is not positive")

    out_dir = os.path.join(WORK, "r3_split_out")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    r = counted("r3_split", lambda: r3_split.run(corpus_dir, device,
                                                 out_dir=out_dir))
    for line in r3_split.lines(r):
        log(f"[tools] r3_split: {line}")
    log(f"[tools] r3_split: {json.dumps(r3_split.record(r))}")
    q13, p = r["routes"]["q13"], r["pass"]
    if not (r["routes"]["f32"]["e2e_equals_kernels"]
            and q13["e2e_equals_kernels"] and q13["equals_engine"]):
        raise AssertionError("r3_split: counts differ between its runs or "
                             "from the engine's")
    if r["files"] != r3_split.FILES or p["n_ok"] != p["n_files"] or (
            p["launches"]["fused_count"] != p["chunks"]):
        raise AssertionError(f"r3_split: {r['files']} files, pass {p}")

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rustsasa_tpu_torch.scripts.precompile_fused",
         "--quick"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"precompile_fused --quick exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"[tools] precompile_fused: {line}")
    r = json.loads(lines[-1])
    log(f"[tools] precompile_fused --quick: {wall:.1f}s wall (process "
        f"start included)")
    # The process's own totals, counted from 0 at the start of its run;
    # every warm_shapes call and every row call carries its launches, and
    # they must add up to the totals.
    total = r["launches"]
    log(f"[tools] precompile_fused: process launches {total}")
    parts = ([c for s in r["shapes"] for c in s["launches"]]
             + [p["launches"] for p in r["pool_vs_serial"]]
             + [c["launches"] for row in r["rows"] for c in row["calls"]])
    if any(n for k, n in total.items() if k not in names) or any(
            total[k] != sum(c[k] for c in parts) for k in names):
        raise AssertionError(f"precompile_fused launches {total} are not "
                             f"its calls' {parts}")
    for k in names:
        launches[k]["precompile_fused"] = total[k]
    n_shapes = len(r["shapes"])
    if any(c != dict.fromkeys(names, 1)
           for s in r["shapes"] for c in s["launches"]) or any(
            p["launches"] != dict.fromkeys(names, n_shapes)
            for p in r["pool_vs_serial"]):
        raise AssertionError(f"precompile_fused warm_shapes launches "
                             f"{r['shapes']} {r['pool_vs_serial']}")
    wires = {w for row in r["rows"] for w, n in row["routes"].items() if n}
    if wires != {"q13", "q16"} or not all(
            c["routes"] == row["routes"]
            and c["launches"]["fused_count"] == sum(c["routes"].values())
            for row in r["rows"] for c in row["calls"]):
        raise AssertionError(f"precompile_fused rows {r['rows']}")
    log(f"[tools] phase 16 took {time.perf_counter() - t_phase:.1f}s")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    log(f"[device] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from rustsasa_tpu_torch.bench import build_corpus

    build_logs = phase_build()
    corpus_dir = os.path.join(WORK, "corpus")
    t0 = time.perf_counter()
    n_files, n_atoms, n_distinct = build_corpus(corpus_dir)
    log(f"[corpus] {n_files} files, {n_atoms} atoms ({n_distinct} distinct "
        f"structures) built in {time.perf_counter() - t0:.1f}s")
    sample_dir = os.path.join(WORK, "sample")
    shutil.rmtree(sample_dir, ignore_errors=True)
    os.makedirs(sample_dir)
    for name in sorted(os.listdir(corpus_dir))[:3]:
        os.symlink(os.path.realpath(os.path.join(corpus_dir, name)),
                   os.path.join(sample_dir, name))

    main_records = phase_kernel_vs_plain(corpus_dir, device, build_logs)
    phase_golden(device, sample_dir, WORK)
    main_launches, main_median = phase_main_path(device)
    for rec in main_records:
        rec["launches"] = main_launches[rec["name"]]
    list_records = phase_list_kernel(device, build_logs)
    list_launches = phase_list_path(device)
    for rec in list_records:
        rec["launches"] = list_launches[rec["name"]]
    phase_host_cull(device, WORK)
    studies = phase_count_studies(corpus_dir, device, build_logs)
    studies_ii = phase_count_studies_ii(corpus_dir, device, build_logs)
    experiments = phase_kernel_experiments(device, build_logs)
    phase_cli(smi)
    phase_trajectory(device, smi)
    phase_quality_gate(device, smi)
    scale_out = phase_scale_out(device, corpus_dir, main_median, smi)
    for rec in list_records:
        rec["scale_out_launches"] = scale_out[rec["name"]]
    profilers = phase_profilers(device, corpus_dir, smi)
    tools = phase_tools(device, corpus_dir, smi)
    for rec in main_records:
        rec["scale_out_launches"] = scale_out[rec["name"]]
        rec["profilers_launches"] = profilers[rec["name"]]
        rec["tools_launches"] = tools[rec["name"]]
    log(f"[smoke] sixteen phases in {time.perf_counter() - t_start:.1f}s")
    log(smi)
    print(json.dumps({"kernels": [*main_records, *list_records, *studies,
                                  *studies_ii, *experiments]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
