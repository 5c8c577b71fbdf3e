#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `rustsasa_tpu_torch/ops/csrc/` and
runs ten phases, each of which must pass:

  1. build: nvcc for sm_90a, one process per kernel source, all started
     together, with the compiler's register/spill report;
  2. count kernel vs plain: one real q13 chunk of up to 524,288 slots from
     the corpus below, counted by the CUDA kernel and by its plain-torch
     version on the same device tensors; counts must be byte-equal at every
     real atom slot; both timed with CUDA events after a warm launch;
  3. golden: example.cif per-atom SASA within 25 A^2 of the stored golden
     array (tests/test_golden.py) and the protein total within 1500 of
     20268; a 3-file directory batch gives byte-identical JSON on CUDA
     and on the CPU (plain-torch kernels);
  4. main path: `process_directory` at residue level, JSON output, on
     CUDA, over a corpus built by bench.py's rule (the 88 FreeSASA test
     structures cycled to >= 4,400 files and >= 10.7M atoms), one warm and
     one timed pass; every file must succeed and the count kernel's launch
     count in the timed pass must equal the chunks the engine dispatched;
  5. list kernel vs plain: the neighbor phase's records for 1jz8 (the
     largest test structure) at 100 points, through the list-occlusion
     kernel and its plain-torch version; byte-equal, both timed, with the
     tiles' neighbor bounds (min, mean, max), the device time of the
     records' four K-major copies and the wrapper's host time a call; and
     byte-equal again at 960 and 50,000 points (several blocks of points a
     tile, beyond one wave of CTAs);
  6. list path: `calculate_sasa_internal(backend="list")` on example.cif
     against the golden array and protein total, and the closed-form cases
     of tests/test_sanity.py at 50,000 points within 0.5 %; the list
     kernel must launch and the count kernel must not;
  7. host-cull wires: `process_directory` over all 88 FreeSASA structures
     on CUDA, with the chunks of each route counted (the three largest
     need the host-cull wires or the list path); their JSON is
     byte-identical to the CPU's; a shared-group-id structure through the
     f32 wire equals the CPU result exactly;
  8. count-kernel studies: on a banded q16 chunk of 524,288 slots
     (w = 32) the per-half (pair64) and nibble-list kernels, and on the
     host-cull f32 chunk of the same structures the tile-saturation kernel
     checking every 1, 2 and 4 entries, each byte-equal to its plain
     version (saturation: counts and entries streamed) and equal to the
     count kernel at every real slot; then the studies' run() at
     2,097,152 slots, kernels only, timed against the count kernel, whose
     launches are the three kernels' launch counts;
  9. count-kernel studies II: on the host-cull f32 chunk of phase 8's
     structures the loop micro-variants (micro_count: prod, split2, g16,
     g24, nosmem) and the reach-test kernel (reach_count: base,
     nogroupcond, jskip, group4, nocond, bf16, bf16p), on their banded q16
     chunk the max-plus kernel (maxplus_count); each byte-equal to its
     plain version for every variant (reach_count: counts and j-rows
     executed), the f32 variants equal to the count kernel at every real
     slot, bf16, bf16p and max-plus with their count difference reported;
     then the three studies' run() at 2,097,152 slots, kernels only, whose
     launches are the three kernels' launch counts;
 10. kernel experiments: the 22 variants of scripts/kernel_experiments.py
     on its synthetic data (64 tiles x 1,408 resident j-rows), on its ones
     and on seeded random j-data, each against its plain version:
     byte-equal sums and executed groups (the DEFAULT variants, on the
     tensor cores, within kernel_experiments.default_bound); then
     kernel_experiments.run() at the script's 512 tiles, whose launches
     are the four sources' (ke_stream, ke_maxplus, ke_bf16, ke_mxu)
     launch counts.

Phases 5, 9 and 10 log the kernels redesigned for this card
(list_occlusion; maxplus_count; ke_mxu's mxu_dots_def, ke_maxplus's six
variants, ke_bf16's two and ke_stream's nobig and noscalar) with their
bound, share of it, FP32 instruction rate, ptxas registers and spills
and shared memory.  Prints the card's name and
power limit, one JSON line with the twelve kernel sources' numbers and a
record of its own for mxu_dots_def (each with its bound: the larger of its FP32
instructions at this run's work over the 33.5T/s issue peak, for the
DEFAULT variants also its mma work over the 989 TFLOP/s bf16
tensor-core peak, and its bytes over 3.35 TB/s), and as its last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Exits non-zero, printing no result, when CUDA is unavailable or any phase
fails.  Everything it writes goes under build/chip_smoke/.
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
TARGET_FILES = 4400
TARGET_ATOMS = 10_700_000
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
}
LARGEST = ("1hbn.pdb.gz", "1n62.pdb.gz", "1jz8.pdb.gz")
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
# Sphere sizes phase 5 also holds the list kernel to its plain version at
# on 1jz8's records: 8 and 391 blocks of points a tile.
LIST_BIG_SPHERES = (960, 50_000)


def log(msg: str) -> None:
    print(msg, flush=True)


def build_corpus(corpus_dir, target_files=TARGET_FILES,
                 target_atoms=TARGET_ATOMS):
    """bench.py's corpus rule: cycle the largest ascending-size prefix of
    the source structures whose mean atom count stays at or under the
    proteome's (10.7M / 4,400), as symlinks, until both targets are met."""
    from rustsasa_tpu_torch.io.read import read_structure

    files = sorted(
        os.path.join(SOURCE_DIR, f) for f in os.listdir(SOURCE_DIR)
        if f.endswith((".pdb", ".cif", ".pdb.gz", ".cif.gz"))
    )
    sizes = {f: read_structure(f).n_atoms() for f in files}
    target_mean = target_atoms / target_files
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
    while count < target_files or n_atoms < target_atoms:
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


def cuda_ms(fn, reps):
    """Mean milliseconds of `fn()` over `reps` runs, after one warm run."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


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
        log(f"[build] {KERNELS[name][0]} -> "
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


def phase_kernel_vs_plain(corpus_dir, device):
    """Kernel and plain version on one real chunk; returns the kernel's
    JSON record (launches filled in later)."""
    import numpy as np
    import torch

    from rustsasa_tpu_torch.ops import engine, fused_kernel as fk
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
    deq_ms, (planes, qvalid) = cuda_ms(lambda: fk.dequant_q13(*wire[:4]), 3)
    cull_ms, jlist = cuda_ms(
        lambda: fk.build_jlist_banded(planes, qvalid, wire[4], w=w), 3
    )
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
    log(f"[kernel] chunk: {len(triples)} structures, {n_atoms} atoms, "
        f"{m} slots ({m // 128} tiles), w={w}, full chunk on both sides, "
        f"{j_per_tile:.2f} j-tiles/tile, {groups * 8 / (m // 128):.1f} "
        f"admitted j-atoms/tile")
    log(f"[kernel] fused_count {kernel_ms:.3f} ms, plain torch "
        f"{plain_ms:.3f} ms; max |diff| at real slots {max_err}, "
        f"all slots equal: {all_equal}")
    log(f"[kernel] {margins / 1e9:.3f}G margins x 7 FP32 instructions = "
        f"{rate / 1e12:.2f}T instructions/s")
    log(f"[kernel] same chunk, other stages: h2d (pinned) {h2d_ms:.3f} ms, "
        f"dequant {deq_ms:.3f} ms, banded cull {cull_ms:.3f} ms")
    if max_err != 0:
        raise AssertionError(f"kernel disagrees with plain at real slots: {max_err}")
    if not np.isfinite(kernel_ms) or int(got[real].min()) < 0:
        raise AssertionError("kernel produced no valid counts")
    return record("fused_count", None, max_err, kernel_ms, plain_ms, kernel_ms,
                  count_bound(margins, 7, m, sphere.shape[0]))


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


def phase_main_path(corpus_dir, n_files, n_atoms, device, work):
    from rustsasa_tpu_torch import (
        BatchedSasaEngine, Level, SASAOptions, SasaParams, process_directory,
    )
    from rustsasa_tpu_torch.native import pipe_library
    from rustsasa_tpu_torch.ops import _kernels

    route = "native C++" if pipe_library() is not None else "Python"
    options = SASAOptions(level=Level.RESIDUE)
    results = {}
    for name in ("warm", "timed"):
        out_dir = os.path.join(work, f"out_{name}")
        shutil.rmtree(out_dir, ignore_errors=True)
        engine = BatchedSasaEngine(SasaParams(), device=device)
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        report = process_directory(
            corpus_dir, out_dir, options, "json", progress=False,
            engine=engine,
        )
        elapsed = time.perf_counter() - t0
        launches = _kernels.launch_counts["fused_count"]
        log(f"[main] {name} pass: {report.n_ok}/{report.n_files} files, "
            f"{n_atoms} atoms in {elapsed:.3f}s "
            f"({n_atoms / elapsed / 1e6:.3f} Matoms/s); host route {route}; "
            f"{engine.chunks_dispatched} chunks dispatched, "
            f"{launches} fused_count launches; errors {len(report.errors)}")
        for e in report.errors[:5]:
            log(f"[main]   error: {e}")
        if report.n_ok != n_files or report.n_files != n_files:
            raise AssertionError(f"{name}: {report.n_ok}/{n_files} files ok")
        if launches != engine.chunks_dispatched or launches == 0:
            raise AssertionError(
                f"{name}: {launches} launches for "
                f"{engine.chunks_dispatched} chunks"
            )
        if not report.total_area > 0.0:
            raise AssertionError(f"{name}: total area {report.total_area}")
        results[name] = (report, launches)
    outputs = sorted(os.listdir(os.path.join(work, "out_timed")))
    if len(outputs) != n_files:
        raise AssertionError(f"{len(outputs)} outputs for {n_files} files")
    with open(os.path.join(work, "out_timed", outputs[0]), encoding="utf-8") as f:
        doc = json.load(f)
    if not doc:
        raise AssertionError(f"empty output {outputs[0]}")
    return results["timed"][1]


def phase_list_kernel(device, build_logs):
    """Kernel 2 and its plain version on the neighbor phase's records for
    the largest test structure; returns its JSON record."""
    import torch

    from rustsasa_tpu_torch.ops import _kernels, engine, neighbors
    from rustsasa_tpu_torch.scripts import layout_probe

    rec = layout_probe.list_records(device, os.path.join(SOURCE_DIR,
                                                         LARGEST[-1]))
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
        f"{rec['neighbor_s'] * 1e3:.1f} ms (host clock, first call)")
    # The wrapper's host time per call: its checks, allocations and
    # launches, enqueued back to back ahead of the card.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        _kernels.list_occlusion(*planes, area, sphere, kmax)
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    log(f"[list-kernel] list_occlusion {kernel_ms:.4f} ms (host "
        f"{host_us:.1f} us a call), its four K-major record copies "
        f"(neighbors.occlusion_sasa) {rec['copy_ms']:.4f} ms, plain torch "
        f"{plain_ms:.3f} ms; max |diff| {max_err}, byte-equal: {equal}")
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
    return record("list_occlusion", None, max_err, kernel_ms, plain_ms, None,
                  work)


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
    """The list path end to end; returns the list kernel's launches."""
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
    if launches["list_occlusion"] == 0 or launches["fused_count"] != 0:
        raise AssertionError(f"list path launches {launches}")
    return launches["list_occlusion"]


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
            or launches["list_occlusion"] != routes["list"]):
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
    """Time a study kernel (10 launches) and its plain version (1) on the
    same tensors; every output byte-equal to the plain version's and, with
    equal_to_prod, the counts equal to fused_count's `prod` at the `real`
    slots (else their difference is only reported).  Returns (ms,
    plain_ms, max |diff| over the outputs, kernel outputs)."""
    import torch

    ms, got = cuda_ms(kernel, 10)
    plain_ms, want = cuda_ms(plain, 1)
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


def phase_count_studies(corpus_dir, device):
    """Phase 8: the count-kernel studies.  Each study kernel against its
    plain version and fused_count on a corpus chunk, then both studies'
    run() at full size, kernels only, with the launches of those runs.
    Returns the three kernels' records."""
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
        lambda: fk.build_jlist_banded(planes, qvalid, tm, w=r5.W), 3)
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

    # Host-cull f32: saturation checked every 1, 2 and 4 entries.
    planes5, jlist5, real5, _atoms, _tiles, failed = _study.host_cull_chunk(
        triples, device, CHECK_CHUNK_SLOTS)
    if failed:
        raise AssertionError(f"{failed} host j-lists overflowed")
    entries = passes * int(jlist5[:, 0].sum())
    margins5 = int(_study.streamed_groups(jlist5).sum()) * lane_margins
    prod5_ms, prod5 = cuda_ms(lambda: fk.fused_counts(planes5, jlist5, sphere),
                              10)
    log(f"[studies] host-cull f32 chunk: {entries} j-list entries over "
        f"{passes} point passes; fused_count {prod5_ms:.3f} ms")
    for ce in r4.CHECKS:
        ms, plain_ms, err, (_, streamed) = _kernel_vs_plain(
            f"saturation_count (check_every={ce})",
            lambda ce=ce: r4.saturation_counts(planes5, jlist5, sphere,
                                               check_every=ce),
            lambda ce=ce: r4.saturation_counts_reference(
                planes5, jlist5, sphere, check_every=ce),
            prod5, real5)
        log(f"[studies]   skipped {entries - int(streamed.sum())} of "
            f"{entries} entries")
        if ce == 1:
            # The margins of the entries it streamed (all on this corpus).
            work = margins5 * int(streamed.sum()) // max(entries, 1)
            m5 = planes5.shape[1]
            records["saturation_count"] = dict(
                record("saturation_count", None, err, ms, plain_ms, prod5_ms,
                       count_bound(work, 7, m5, p, extra_out=4 * m5 // 128)),
                check_every=1)

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
    log(f"[studies] builders vs build_jlist_banded: " + ", ".join(
        f"{k} {v['ms']:.3f} ms" for k, v in pair["builders"].items()))
    log(f"[studies] streamed j-atoms/atom: prod "
        f"{pair['variants']['prod']['j_atoms_per_atom']:.1f}, pair64 "
        f"{pair['variants']['pair64']['j_atoms_per_atom']:.1f}")
    prod_sat = sat["variants"]["prod"]["ms"]
    for ce in r4.CHECKS:
        v = sat["variants"][f"sat{ce}"]
        log(f"[studies] saturation_count check_every={ce} {v['ms']:.3f} ms vs "
            f"fused_count {prod_sat:.3f} ms on the host-cull chunk "
            f"({v['ms'] / prod_sat:.3f}x); skipped "
            f"{100 * v['skipped']:.3f} % of entries")
    for result in (pair, sat):
        for name, v in result["variants"].items():
            if v["max_dcount"] != 0:
                raise AssertionError(f"full size: {name} differs from prod")
    for name in records:
        records[name]["launches"] = launches[name]
        if launches[name] == 0:
            raise AssertionError(f"{name} did not launch in the studies' runs")
    log(f"[studies] phase 8 took {time.perf_counter() - t_phase:.1f}s")
    return list(records.values())


def phase_count_studies_ii(corpus_dir, device, build_logs):
    """Phase 9: the count-kernel studies II.  The loop micro-variants and
    the reach-test kernel on a host-cull f32 corpus chunk, the max-plus
    kernel on the banded q16 chunk of the same structures, each against
    its plain version for every variant and against fused_count; then the
    three studies' run() at full size, kernels only, with the launches of
    those runs.  Returns the three kernels' records."""
    from rustsasa_tpu_torch.ops import _kernels, engine, fused_kernel as fk
    from rustsasa_tpu_torch.scripts import _study
    from rustsasa_tpu_torch.scripts import r3_kernel_variants as r3v
    from rustsasa_tpu_torch.scripts import r3_maxplus as r3m
    from rustsasa_tpu_torch.scripts import r4_microkernel as r4m

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
    for variant in r4m.VARIANTS:
        ms, plain_ms, err, _ = _kernel_vs_plain(
            f"micro_count ({variant})",
            lambda v=variant: r4m.micro_counts(planes, jl, sphere, variant=v),
            lambda v=variant: r4m.micro_counts_reference(planes, jl, sphere,
                                                         variant=v),
            prod, real)
        if variant == r4m.VARIANTS[0]:
            records["micro_count"] = dict(record(
                "micro_count", None, err, ms, plain_ms, prod_ms,
                count_bound(groups[variant] * 8 * 128 * points, 7, m, p)),
                variant=variant)
    for variant in r3v.VARIANTS:
        ms, plain_ms, err, (_, executed) = _kernel_vs_plain(
            f"reach_count ({variant})",
            lambda v=variant: r3v.reach_counts(planes, jl, sphere, variant=v),
            lambda v=variant: r3v.reach_counts_reference(planes, jl, sphere,
                                                         variant=v),
            prod, real, equal_to_prod=variant in r3v.F32_VARIANTS)
        rows = int(executed.sum()) // passes
        log(f"[studies-ii]   {rows / max(int((jl[:, 0] > 0).sum()), 1):.1f} "
            f"j-atoms/atom executed, fused_count streams "
            f"{groups['prod'] * 8 / max(int((jl[:, 0] > 0).sum()), 1):.1f}")
        if variant == r3v.VARIANTS[0]:
            records["reach_count"] = dict(record(
                "reach_count", None, err, ms, plain_ms, prod_ms,
                count_bound(rows * 128 * points, 7, m, p,
                            extra_out=4 * m // 128)),
                variant=variant)

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
    log(f"[studies-ii] maxplus_count at {margins_q * 2 / (ms * 1e-3) / 1e12:.2f}T "
        f"FP32 instr/s at its own work (2 per margin), fused_count at "
        f"{margins_q * 7 / (prod_q_ms * 1e-3) / 1e12:.2f}T (7 per margin)")
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
    r3v.report(reach, device, "[studies-ii] r3_kernel_variants")
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

    build_logs = phase_build()
    corpus_dir = os.path.join(WORK, "corpus")
    t0 = time.perf_counter()
    n_files, n_atoms, n_distinct = build_corpus(corpus_dir)
    log(f"[corpus] {n_files} files, {n_atoms} atoms ({n_distinct} distinct "
        f"structures) built in {time.perf_counter() - t0:.1f}s")
    if n_files < TARGET_FILES or n_atoms < TARGET_ATOMS:
        raise AssertionError("corpus below the proteome-equivalent size")
    sample_dir = os.path.join(WORK, "sample")
    shutil.rmtree(sample_dir, ignore_errors=True)
    os.makedirs(sample_dir)
    for name in sorted(os.listdir(corpus_dir))[:3]:
        os.symlink(os.path.realpath(os.path.join(corpus_dir, name)),
                   os.path.join(sample_dir, name))

    count = phase_kernel_vs_plain(corpus_dir, device)
    phase_golden(device, sample_dir, WORK)
    count["launches"] = phase_main_path(
        corpus_dir, n_files, n_atoms, device, WORK
    )
    listed = phase_list_kernel(device, build_logs)
    listed["launches"] = phase_list_path(device)
    phase_host_cull(device, WORK)
    studies = phase_count_studies(corpus_dir, device)
    studies_ii = phase_count_studies_ii(corpus_dir, device, build_logs)
    experiments = phase_kernel_experiments(device, build_logs)
    log(f"[smoke] ten phases in {time.perf_counter() - t_start:.1f}s")
    log(smi)
    print(json.dumps({"kernels": [count, listed, *studies, *studies_ii,
                                  *experiments]}))
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
