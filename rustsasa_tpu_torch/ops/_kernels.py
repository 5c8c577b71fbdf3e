"""Build, load and launch the port's hand-written CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface and loaded with ctypes: no
PyTorch headers, so a build takes seconds, and the sources build in
parallel (one nvcc each, all started together).  The build happens at
first use, into `build/rustsasa_tpu_torch/` beside the package (the
user's `~/.cache/rustsasa_tpu_torch/` where that cannot be written, as
for a wheel in a read-only site-packages), keyed by a hash of the
source, the shared `.cuh` headers and the flags; nothing is built or
imported when this module is imported.  Every launch is counted in
`launch_counts`, so a run can show that its work went through the
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..utils import build_cache

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
# build/rustsasa_tpu_torch/ beside the package, or the user's cache where
# that cannot be written (utils/build_cache.py).
BUILD_DIR = build_cache.build_dir()
# --fmad=false: counts are held bit-exact against the reference, whose
# margins round every multiply and add separately.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
MAX_P_PAD = 2048
# Sphere points per thread and slices per CTA of the count kernels
# (csrc/count_tile.cuh kMaxK, kSlices; the kernels on kernel 1's layout,
# csrc/reach_ring.cuh, have no slices).
MAX_K = 16
SLICES = 4
# Lanes an i-atom gets in csrc/reach_ring.cuh's layout (kLanes: kernel 1,
# saturation_count.cu, micro_count.cu, reach_count.cu, nibble_count.cu,
# pair64_count.cu); a lane holds up to MAX_K sphere points in a pass.
COUNT_LANES = 16
# Words a tile of csrc/saturation_count.cu shares its check through
# (kSyncWords: each of up to 8 passes' saturated warps and largest first
# saturated check, and the tile's finished CTAs).
SATURATION_SYNC_WORDS = 17
# Variant codes of csrc/micro_count.cu and csrc/reach_count.cu, in order.
MICRO_VARIANTS = ("prod", "split2", "g16", "g24", "nosmem")
REACH_VARIANTS = ("base", "nogroupcond", "jskip", "group4", "nocond", "bf16",
                  "bf16p")
# Sphere points a list-occlusion CTA covers (csrc/list_occlusion.cu
# kBlockPoints: 2 halves of up to 64 points), and the instructions each
# (point, atom, k) triple needs: 3 FMUL, 2 FADD and one FSETP.LT.OR that
# folds the compare into the point's predicate (the kernel's loop, by
# scripts/sass_mix.py: 407 instructions for 16 records x 4 points, 384
# of them these).
LIST_BLOCK_POINTS = 128
LIST_INSTR_PER_TRIPLE = 6
# Variants of the kernel-experiment sources (csrc/ke_*.cu), in the order
# of their codes; the names are scripts/kernel_experiments.py's.
KE_VARIANTS = {
    "ke_stream": ("full", "noscalar", "nogid", "nobig", "group8",
                  "group8_smem", "g8", "g8_fma", "g8_fma_skip", "g8_hoist",
                  "g8_hoist_skip"),
    "ke_maxplus": ("mp_tile_hi", "mp_tile_def", "mp_tile_hi_skip",
                   "mp_group_hi", "mp_group_def", "mp_tile_hi_sat"),
    "ke_bf16": ("g8_bf16", "g8_bf16_skip"),
    "ke_mxu": ("mxu_dots_hi", "mxu_dots_def", "mxu_dots_hi_skip"),
}
# Sphere points and i-atoms of a kernel experiment, and the most j-rows
# its shared memory holds (8 floats a row beside the other buffers).
KE_POINTS = 128
KE_MAX_NJ = 2048

launch_counts = {
    "fused_count": 0, "fused_count_rows": 0, "list_occlusion": 0,
    "pair64_count": 0,
    "nibble_count": 0, "saturation_count": 0, "micro_count": 0,
    "reach_count": 0, "reach_rule": 0, "maxplus_count": 0, "ke_stream": 0,
    "ke_maxplus": 0, "ke_bf16": 0, "ke_mxu": 0, "dequant_boxes": 0,
    "band_jlist": 0, "cell_keys": 0, "neighbor_cells": 0,
}
_count_lock = threading.Lock()
_build_lock = threading.Lock()
_launchers: dict = {}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
_DOUBLE = ctypes.c_double
# C signature of each kernel's launch function <name>_launch, by name.
_SIGNATURES = {
    "fused_count": [_VOIDP] * 4 + [_INT] * 2 + [_VOIDP],
    "fused_count_rows": [_VOIDP] * 5 + [_INT] * 2 + [_VOIDP],
    "list_occlusion": [_VOIDP] * 9 + [_INT] * 6 + [_VOIDP],
    "pair64_count": [_VOIDP] * 5 + [_INT] * 2 + [_VOIDP],
    "nibble_count": [_VOIDP] * 6 + [_INT] * 2 + [_VOIDP],
    "saturation_count": [_VOIDP] * 6 + [_INT] * 3 + [_VOIDP],
    "micro_count": [_VOIDP] * 4 + [_INT] * 3 + [_VOIDP],
    "reach_count": [_VOIDP] * 6 + [_INT] * 3 + [_VOIDP],
    "reach_rule": [_VOIDP] * 4 + [_INT] * 3 + [_VOIDP],
    "maxplus_count": [_VOIDP] * 4 + [_INT] * 2 + [_VOIDP],
    **{name: [_VOIDP] * 5 + [_INT] * 3 + [_VOIDP] for name in KE_VARIANTS},
    "dequant_boxes": [_INT] + [_VOIDP] * 12 + [_INT, _VOIDP],
    "band_jlist": [_VOIDP] * 10 + [_INT] * 2 + [_VOIDP],
    "cell_keys": [_VOIDP] * 12 + [_INT] * 2 + [_DOUBLE, _VOIDP],
    "neighbor_cells": [_VOIDP] * 11 + [_INT] * 4 + [_FLOAT] * 2 + [_VOIDP],
}
# The source (csrc/<source>.cu) of each launch function not named after
# its own; every source builds to one library.
_SOURCE_OF = {"dequant_boxes": "band_cull", "band_jlist": "band_cull",
              "fused_count_rows": "fused_count",
              "reach_rule": "reach_count",
              "cell_keys": "neighbor_cells"}
SOURCES = tuple(dict.fromkeys(_SOURCE_OF.get(n, n) for n in _SIGNATURES))
# dequant_boxes' wire codes (csrc/band_cull.cu Wire).
WIRES = ("q13", "q16", "planes")
# Largest band width band_jlist takes (fused_kernel.JLIST_CAP), and the
# most slots: the gid plane holds slot + 1 as an exact f32.
MAX_BAND_W = 127
MAX_BAND_SLOTS = 1 << 24
# Structures a cell_keys or neighbor_cells batch may hold
# (csrc/neighbor_cells.cu kMaxBatch).
MAX_CELL_BATCH = 511


class CellOrder(NamedTuple):
    """The cell list of a [B, N] batch: keys [B*N] i64 by atom ((structure
    << 54) | (cell x << 36) | (cell y << 18) | cell z, PAD_KEY for
    padding), each structure's largest real radius max_r [B] f32 and cell
    edge h [B] f64; the keys' stable sort, sorted_keys and perm [B*N] i64
    (torch.sort(keys, stable=True)'s values and indices); and the atoms in
    that order, sorted_packed [B*N, 4] f32 and sorted_gid [B*N] i32."""
    keys: torch.Tensor
    max_r: torch.Tensor
    h: torch.Tensor
    sorted_keys: torch.Tensor
    perm: torch.Tensor
    sorted_packed: torch.Tensor
    sorted_gid: torch.Tensor


class Boxes(NamedTuple):
    """The banded cull's boxes of a chunk of T tiles: each tile's 8-atom
    groups' min and max corners [T, 16, 3] and largest r_eff [T, 16],
    and the tile's [T, 3] and [T] (padding slots count as +3e4 / -3e4
    and r_eff 0)."""
    gmin: torch.Tensor
    gmax: torch.Tensor
    gmaxr: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor
    tmaxr: torch.Tensor


@dataclass(frozen=True)
class BuildInfo:
    path: str
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc/ptxas output of the build that made the library


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def point_passes(p: int) -> tuple[int, int]:
    """(passes, K) of the count kernels for a P-point sphere: the fewest
    passes of SLICES x MAX_K points, then the smallest K points per
    thread covering P.  A pass covers points [pass*SLICES*K,
    (pass+1)*SLICES*K)."""
    passes = -(-p // (SLICES * MAX_K))
    return passes, -(-p // (SLICES * passes))


def lane_passes(p: int) -> tuple[int, int]:
    """(passes, K) of the kernels on csrc/reach_ring.cuh's layout
    (fused_count.cu, saturation_count.cu, micro_count.cu) for a P-point
    sphere: the fewest passes of COUNT_LANES x MAX_K points, then the
    smallest K points a lane covering P.  Lane q of an atom holds points
    [(pass*COUNT_LANES + q)*K, (pass*COUNT_LANES + q + 1)*K) in pass
    `pass`."""
    passes = -(-p // (COUNT_LANES * MAX_K))
    return passes, -(-p // (COUNT_LANES * passes))


def list_point_plan(p: int) -> tuple[int, int, int]:
    """(blocks, block points pb, half points hp) of the list-occlusion
    kernel for a P-point sphere: the fewest blocks of at most
    LIST_BLOCK_POINTS points, split evenly.  Block b covers points
    [b*pb, min(P, (b+1)*pb)), its half h [b*pb + h*hp, min(block end,
    b*pb + (h+1)*hp))."""
    if p <= 0:
        raise ValueError(f"list_point_plan: {p} points")
    blocks = -(-p // LIST_BLOCK_POINTS)
    pb = -(-p // blocks)
    return blocks, pb, -(-pb // 2)


def _target(name: str) -> str:
    """Library path keyed by the flags, the source and the shared
    headers it may include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build() -> dict[str, BuildInfo]:
    """Compile each csrc/<name>.cu into its keyed shared library (once);
    the missing ones build in parallel."""
    out = {}
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        target = _target(name)
        if os.path.exists(target):
            with open(target + ".log", encoding="utf-8") as f:
                out[name] = BuildInfo(target, 0.0, f.read())
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    for name, (target, tmp, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"({proc.returncode}):\n{log}")
        with open(target + ".log", "w", encoding="utf-8") as f:
            f.write(log)
        os.replace(tmp, target)
        out[name] = BuildInfo(target, time.perf_counter() - t0, log)
    return out


def cut_sources(name: str, cuts) -> dict[str, str]:
    """{tag: csrc/<name>.cu with each (text, replacement) of that tag's
    list applied}, for the (tag, [(text, replacement), ...]) pairs of
    `cuts`: the studies' timing-only builds of a kernel with a part cut
    out.  RuntimeError if a text is not in the source exactly once."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), encoding="utf-8") as f:
        text = f.read()
    sources = {}
    for tag, subs in cuts:
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{tag}: cut does not apply to {name}.cu")
            src = src.replace(old, new)
        sources[tag] = src
    return sources


def build_sources(stem: str, sources: dict[str, str], fn_name: str,
                  argtypes) -> dict:
    """{tag: the C function fn_name of sources[tag]}, each source text
    built in parallel (csrc/ on the include path) into BUILD_DIR as
    <stem>_<tag>_<hash of text and flags>."""
    procs = {}
    for tag, src in sources.items():
        key = hashlib.sha256((src + " ".join(NVCC_FLAGS)).encode())
        path = os.path.join(BUILD_DIR, f"{stem}_{tag}_{key.hexdigest()[:12]}")
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(path + ".cu", "w", encoding="utf-8") as f:
            f.write(src)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", path + ".so",
               path + ".cu"]
        procs[tag] = (path + ".so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {tag} build:\n{log}")
        fn = getattr(ctypes.CDLL(lib), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[tag] = fn
    return fns


def _library(name: str):
    with _build_lock:
        if name not in _launchers:
            built = build()
            for fn_name, argtypes in _SIGNATURES.items():
                if fn_name in _launchers:
                    continue
                lib = ctypes.CDLL(built[_SOURCE_OF.get(fn_name, fn_name)].path)
                fn = getattr(lib, f"{fn_name}_launch")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _launchers[fn_name] = fn
        return _launchers[name]


def _check(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _count_inputs(name, planes, sphere, jplanes):
    """Checks shared by the count kernels: planes [>= 5, M] f32, sphere
    [P, 4] f32 and each j-list plane [M/128, 128] i32, contiguous on one
    CUDA device; M a positive multiple of 128 and 0 < P <= 2048.
    Returns (device, M, P)."""
    device = planes.device
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")
    _check("planes", planes, torch.float32, 2, device)
    _check("sphere", sphere, torch.float32, 2, device)
    m = planes.shape[1]
    p = sphere.shape[0]
    if planes.shape[0] < 5 or m == 0 or m % 128:
        raise ValueError(f"planes shape {tuple(planes.shape)} unsupported")
    for jname, t in jplanes.items():
        _check(jname, t, torch.int32, 2, device)
        if tuple(t.shape) != (m // 128, 128):
            raise ValueError(
                f"{jname} shape {tuple(t.shape)} != ({m // 128}, 128)"
            )
    if sphere.shape[1] != 4 or not 0 < p <= MAX_P_PAD:
        raise ValueError(f"sphere shape {tuple(sphere.shape)} unsupported")
    return device, m, p


def _aligned(name, planes):
    """Kernel 1's layout reads each tile's 512-byte plane rows (a row
    stride of M) by bulk copies, which need 16-byte alignment."""
    if planes.data_ptr() % 16:
        raise ValueError(f"{name}: planes must start on a 16-byte boundary")


def _launch(name, device, *args):
    """Launch kernel `name` with pointer/int `args` on the current stream
    of `device`; raise if the launch was refused, count it if not."""
    launch = _library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}_launch failed: cudaError {rc}")
    _count(name)


def fused_count(planes, jlist, sphere, *, rows: bool = False):
    """Launch the occlusion-count kernel on the current stream -> [M] i32.

    planes [8, M] f32 (16-byte aligned), jlist [M/128, 128] i32, sphere
    [P, 4] f32, all contiguous on one CUDA device; M a positive multiple
    of 128 and 0 < P <= 2048.  Counts at real slots equal
    fused_kernel.fused_counts_reference's bit for bit.  A padding slot
    (gid 0) skips every j-row, so its count is its valid points, not the
    reference's; nothing reads those slots (`CountsView` and the studies
    read real slots only, and fused_sasa's area is 0 there).

    With rows, launches the instantiation that also counts the j-rows
    each warp streamed over all passes (counted as "fused_count_rows")
    and returns (counts, rows [M/128, 4 * COUNT_LANES] i32), warp w of a
    tile holding its atoms [w*32/COUNT_LANES, (w+1)*32/COUNT_LANES): for
    checking the skip; the main path does not ask for it.
    """
    name = "fused_count_rows" if rows else "fused_count"
    device, m, p = _count_inputs(name, planes, sphere, {"jlist": jlist})
    _aligned(name, planes)
    out = torch.empty(m, dtype=torch.int32, device=device)
    if not rows:
        _launch(name, device, planes.data_ptr(), jlist.data_ptr(),
                sphere.data_ptr(), out.data_ptr(), m, p)
        return out
    streamed = torch.empty((m // 128, 4 * COUNT_LANES), dtype=torch.int32,
                           device=device)
    _launch(name, device, planes.data_ptr(), jlist.data_ptr(),
            sphere.data_ptr(), out.data_ptr(), streamed.data_ptr(), m, p)
    return out, streamed


def pair64_count(planes, jlist_a, jmask_b, sphere):
    """Launch the per-half admission count kernel -> [M] i32.

    As fused_count (planes 16-byte aligned, kernel 1's layout), but atoms
    0-63 of a tile stream the groups of the entry's mask A ((mask_a << 16)
    | j in jlist_a) and atoms 64-127 those of mask B (the low 16 bits of
    the same cell of jmask_b).  Counts equal
    r5_pair64.pair64_counts_reference's at every slot.
    """
    device, m, p = _count_inputs("pair64_count", planes, sphere,
                                 {"jlist_a": jlist_a, "jmask_b": jmask_b})
    _aligned("pair64_count", planes)
    out = torch.empty(m, dtype=torch.int32, device=device)
    _launch("pair64_count", device, planes.data_ptr(), jlist_a.data_ptr(),
            jmask_b.data_ptr(), sphere.data_ptr(), out.data_ptr(), m, p)
    return out


def nibble_count(planes, jl, w1, w2, sphere):
    """Launch the nibble-list count kernel -> [M] i32.

    As fused_count (planes 16-byte aligned, kernel 1's layout), but an
    entry is (gcount << 16) | j and its admitted group ids are the first
    gcount 4-bit nibbles of w1 (0-7) and w2 (8-15) in the same cells,
    four of them a reach-test chunk.  Counts equal
    r5_pair64.nibble_counts_reference's at every slot.
    """
    device, m, p = _count_inputs("nibble_count", planes, sphere,
                                 {"jl": jl, "w1": w1, "w2": w2})
    _aligned("nibble_count", planes)
    out = torch.empty(m, dtype=torch.int32, device=device)
    _launch("nibble_count", device, planes.data_ptr(), jl.data_ptr(),
            w1.data_ptr(), w2.data_ptr(), sphere.data_ptr(), out.data_ptr(),
            m, p)
    return out


def saturation_count(planes, jlist, sphere, check_every: int):
    """Launch the tile-saturation count kernel -> (counts [M] i32,
    streamed [M/128] i32).

    fused_count's inputs (planes 16-byte aligned) and its layout, four
    CTAs a tile; after every check_every-th j-list entry a tile whose
    points of the current pass (lane_passes' split) are all occluded for
    all 128 atoms leaves that pass's entry loop; streamed[tile] sums the
    entries each pass went through.  Counts equal
    fused_kernel.fused_counts_reference's at every slot.  The tile's
    CTAs share their check through SATURATION_SYNC_WORDS zeroed words.
    """
    device, m, p = _count_inputs("saturation_count", planes, sphere,
                                 {"jlist": jlist})
    if check_every < 1:
        raise ValueError(f"check_every {check_every} < 1")
    _aligned("saturation_count", planes)
    out = torch.empty(m, dtype=torch.int32, device=device)
    streamed = torch.empty(m // 128, dtype=torch.int32, device=device)
    sync = torch.zeros((m // 128, SATURATION_SYNC_WORDS), dtype=torch.int32,
                       device=device)
    _launch("saturation_count", device, planes.data_ptr(), jlist.data_ptr(),
            sphere.data_ptr(), out.data_ptr(), streamed.data_ptr(),
            sync.data_ptr(), m, p, check_every)
    return out, streamed


def variant_code(name, variant, variants):
    """The code of `variant` among `variants`, as the C launcher takes it;
    ValueError for an unknown name."""
    if variant not in variants:
        raise ValueError(f"{name}: unknown variant {variant!r}, expected one "
                         f"of {variants}")
    return variants.index(variant)


def micro_count(planes, jlist, sphere, variant: str):
    """Launch the loop-variant count kernel -> [M] i32.

    fused_count's inputs (planes 16-byte aligned) and its layout, with the
    loop over a chunk's kept rows reshaped by `variant` (one of
    MICRO_VARIANTS; nosmem streams every row instead); every variant
    gives fused_kernel.fused_counts_reference's counts at every slot.
    """
    code = variant_code("micro_count", variant, MICRO_VARIANTS)
    device, m, p = _count_inputs("micro_count", planes, sphere,
                                 {"jlist": jlist})
    _aligned("micro_count", planes)
    out = torch.empty(m, dtype=torch.int32, device=device)
    _launch("micro_count", device, planes.data_ptr(), jlist.data_ptr(),
            sphere.data_ptr(), out.data_ptr(), m, p, code)
    return out


def reach_count(planes, jlist, sphere, variant: str):
    """Launch the reach-test count kernels -> (counts [M] i32, executed
    [M/128] i32).

    Every live entry's j-tile (entry & 0xFFFF; mask bits ignored) is
    streamed under the reach test of `variant` (one of REACH_VARIANTS);
    executed[tile] sums the rule's j-rows over the entries, times
    point_passes' passes.  One launch (counted once) runs the rule kernel,
    which writes each entry's rows into scratch words, then the count
    kernel on kernel 1's layout (planes 16-byte aligned).  Counts equal
    r3_kernel_variants.reach_counts_reference's at every slot.
    """
    code = variant_code("reach_count", variant, REACH_VARIANTS)
    device, m, p = _count_inputs("reach_count", planes, sphere,
                                 {"jlist": jlist})
    _aligned("reach_count", planes)
    out = torch.empty(m, dtype=torch.int32, device=device)
    executed = torch.empty(m // 128, dtype=torch.int32, device=device)
    rule = torch.empty((m // 128, 128, 4), dtype=torch.int32, device=device)
    _launch("reach_count", device, planes.data_ptr(), jlist.data_ptr(),
            sphere.data_ptr(), out.data_ptr(), executed.data_ptr(),
            rule.data_ptr(), m, p, code)
    return out, executed


def reach_rule(planes, jlist, sphere, variant: str):
    """Launch reach_count's first kernel alone -> (rule [M/128, 128, 4]
    i32, executed [M/128] i32): each live entry's rule rows as four
    32-row words at its j-list position (other cells unwritten), and
    reach_count's executed.  For timing the rule kernel apart
    (chip_smoke.py); counted as "reach_rule"."""
    code = variant_code("reach_rule", variant, REACH_VARIANTS)
    device, m, p = _count_inputs("reach_rule", planes, sphere,
                                 {"jlist": jlist})
    executed = torch.empty(m // 128, dtype=torch.int32, device=device)
    rule = torch.empty((m // 128, 128, 4), dtype=torch.int32, device=device)
    _launch("reach_rule", device, planes.data_ptr(), jlist.data_ptr(),
            executed.data_ptr(), rule.data_ptr(), m, p, code)
    return rule, executed


def maxplus_count(planes, jlist, sphere):
    """Launch the max-plus count kernel -> [M] i32.

    fused_count's inputs; the margin is taken as (LIMT + TJ) - SXI with
    the K = 3 products as fused multiply-add chains, so boundary points
    may differ from fused_count's counts.
    """
    device, m, p = _count_inputs("maxplus_count", planes, sphere,
                                 {"jlist": jlist})
    out = torch.empty(m, dtype=torch.int32, device=device)
    _launch("maxplus_count", device, planes.data_ptr(), jlist.data_ptr(),
            sphere.data_ptr(), out.data_ptr(), m, p)
    return out


def kernel_experiment(name, variant, sphere, planes, jdata):
    """Launch kernel-experiment source `name` (one of KE_VARIANTS) for
    `variant` -> (sums [M] f32, executed [M/128] i32).

    sphere [128, 4] f32 (x, y, z, 0), planes [8, M] f32 (rows x, y, z,
    r_eff, gid of the i-atoms), jdata [NJ, 8] f32 (columns x, y, z, r,
    gid of the resident j-atoms), all contiguous on one CUDA device; M a
    positive multiple of 128, NJ a positive multiple of 8 (of 128 for
    ke_maxplus, which streams whole 128-row j-tiles) up to KE_MAX_NJ.
    sums[i] is the sum over the points, in order, of the largest margin
    over j; executed[tile] counts the 8-row groups the tile ran.
    """
    if name not in KE_VARIANTS:
        raise ValueError(f"unknown kernel-experiment source {name!r}")
    code = variant_code(name, variant, KE_VARIANTS[name])
    device = planes.device
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")
    _check("sphere", sphere, torch.float32, 2, device)
    _check("planes", planes, torch.float32, 2, device)
    _check("jdata", jdata, torch.float32, 2, device)
    m = planes.shape[1]
    nj = jdata.shape[0]
    rows = 128 if name == "ke_maxplus" else 8
    if tuple(sphere.shape) != (KE_POINTS, 4):
        raise ValueError(f"sphere shape {tuple(sphere.shape)} != (128, 4)")
    if planes.shape[0] != 8 or m == 0 or m % 128:
        raise ValueError(f"planes shape {tuple(planes.shape)} unsupported")
    if jdata.shape[1] != 8 or nj == 0 or nj % rows or nj > KE_MAX_NJ:
        raise ValueError(f"jdata shape {tuple(jdata.shape)} unsupported")
    out = torch.empty(m, dtype=torch.float32, device=device)
    executed = torch.empty(m // 128, dtype=torch.int32, device=device)
    _launch(name, device, sphere.data_ptr(), planes.data_ptr(),
            jdata.data_ptr(), out.data_ptr(), executed.data_ptr(), m, nj,
            code)
    return out, executed


def list_occlusion(vx, vy, vz, limit, area, sphere, tile_kmax):
    """Launch the list-path occlusion kernel on the current stream ->
    per-atom SASA [N] f32.

    vx, vy, vz, limit [K, N] f32 (K-major), area [N] f32, sphere [P, 4]
    f32, tile_kmax [ceil(N/128)] i32, all contiguous on one CUDA device;
    N, K, P positive, N a multiple of 4 (`neighbors.occlusion_sasa` pads
    to one).  Any number of sphere points.
    """
    device = limit.device
    if device.type != "cuda":
        raise ValueError(f"list_occlusion needs CUDA tensors, got {device}")
    for name, t in (("vx", vx), ("vy", vy), ("vz", vz), ("limit", limit)):
        _check(name, t, torch.float32, 2, device)
    _check("area", area, torch.float32, 1, device)
    _check("sphere", sphere, torch.float32, 2, device)
    _check("tile_kmax", tile_kmax, torch.int32, 1, device)
    k, n = limit.shape
    p = sphere.shape[0]
    if k == 0 or n == 0:
        raise ValueError(f"limit shape {tuple(limit.shape)} unsupported")
    for name, t in (("vx", vx), ("vy", vy), ("vz", vz)):
        if t.shape != limit.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(k, n)}")
    if tuple(area.shape) != (n,):
        raise ValueError(f"area shape {tuple(area.shape)} != ({n},)")
    if sphere.shape[1] != 4 or p == 0:
        raise ValueError(f"sphere shape {tuple(sphere.shape)} unsupported")
    if tuple(tile_kmax.shape) != (-(-n // 128),):
        raise ValueError(
            f"tile_kmax shape {tuple(tile_kmax.shape)} != ({-(-n // 128)},)"
        )
    if n % 4:
        raise ValueError(f"list_occlusion: N = {n} is not a multiple of 4 "
                         "(the kernel copies record rows 16 bytes at a time)")
    blocks, pb, hp = list_point_plan(p)
    out = torch.empty(n, dtype=torch.float32, device=device)
    # Integer counts the blocks of points add to, when there are several.
    counts = (torch.empty(n, dtype=torch.int32, device=device)
              if blocks > 1 else None)
    _launch("list_occlusion", device, vx.data_ptr(), vy.data_ptr(),
            vz.data_ptr(), limit.data_ptr(), area.data_ptr(),
            sphere.data_ptr(), tile_kmax.data_ptr(),
            None if counts is None else counts.data_ptr(), out.data_ptr(),
            n, k, p, blocks, pb, hp)
    return out


def _band_slots(m: int) -> None:
    if m == 0 or m % 128 or m >= MAX_BAND_SLOTS:
        raise ValueError(f"{m} slots: need a positive multiple of 128 "
                         f"under {MAX_BAND_SLOTS}")


def _check_shape(name, t, shape):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")


def _on_cuda(name, device):
    """The last check before a launch: shapes and types are checked on
    any device, so the CPU tests reach them."""
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _box_shapes(t):
    return ((t, 16, 3), (t, 16, 3), (t, 16), (t, 3), (t, 3), (t,))


def _dequant_outputs(wire, m, device, boxes=True):
    """dequant_boxes' outputs for `wire` (one of WIRES) over m slots, as
    views of one buffer -> (planes [8, m] f32, qvalid [m] bool, Boxes):
    planes and qvalid None for "planes" (which reads them), the boxes
    None unless `boxes`.  Each f32 view starts on a 64-byte boundary."""
    shapes = [] if wire == "planes" else [(8, m)]
    if boxes:
        shapes += _box_shapes(m // 128)
    sizes = [math.prod(shape) for shape in shapes]
    spans = [-(-n // 16) * 16 for n in sizes]
    floats = 4 * sum(spans)
    buf = torch.empty(floats + (0 if wire == "planes" else m),
                      dtype=torch.uint8, device=device)
    views = [span[:n].view(shape) for span, n, shape in zip(
        buf[:floats].view(torch.float32).split(spans), sizes, shapes)]
    planes = qvalid = None
    if wire != "planes":
        planes = views.pop(0)
        qvalid = buf[floats:].view(torch.bool)
    return planes, qvalid, Boxes(*views) if boxes else None


def _dequant_boxes(wire, in0, in1, palette=None, tparams=None, *,
                   boxes=True):
    """Allocate the outputs of `wire` and launch dequant_boxes ->
    _dequant_outputs' (planes, qvalid, Boxes)."""
    device = in0.device
    m = in0.shape[-1]
    planes, qvalid, out = _dequant_outputs(wire, m, device, boxes)
    ptrs = (None,) * 6 if out is None else (b.data_ptr() for b in out)
    _launch("dequant_boxes", device, WIRES.index(wire), _ptr(in0), _ptr(in1),
            _ptr(palette), _ptr(tparams), _ptr(planes), _ptr(qvalid), *ptrs,
            m)
    return planes, qvalid, out


def dequant_q13(wire_a, wire_b, palette, tparams, *, boxes=True):
    """Launch dequant_boxes on the q13 wire -> (planes [8, M] f32, qvalid
    [M] bool, Boxes, or None where `boxes` is false and none are
    written).

    wire_a [M] i32 (the u32 words), wire_b [M] i16 (the u16 words),
    palette [256] f32, tparams [M/128, 4] f32 (origin x, y, z, scale),
    contiguous on one CUDA device; 0 < M < 2^24, M % 128 == 0.
    """
    device = wire_a.device
    _check("wire_a", wire_a, torch.int32, 1, device)
    _check("wire_b", wire_b, torch.int16, 1, device)
    _check("palette", palette, torch.float32, 1, device)
    _check("tparams", tparams, torch.float32, 2, device)
    m = wire_a.shape[0]
    _band_slots(m)
    _check_shape("wire_b", wire_b, (m,))
    _check_shape("palette", palette, (256,))
    _check_shape("tparams", tparams, (m // 128, 4))
    _on_cuda("dequant_boxes", device)
    return _dequant_boxes("q13", wire_a, wire_b, palette, tparams,
                          boxes=boxes)


def dequant_q16(planes4, tparams, *, boxes=True):
    """Launch dequant_boxes on the q16 wire -> (planes [8, M] f32, qvalid
    [M] bool, Boxes or None), as dequant_q13.

    planes4 [4, M] i16 (the u16 qx, qy, qz, qr), tparams [M/128, 4] f32,
    contiguous on one CUDA device; 0 < M < 2^24, M % 128 == 0.
    """
    device = planes4.device
    _check("planes4", planes4, torch.int16, 2, device)
    _check("tparams", tparams, torch.float32, 2, device)
    m = planes4.shape[1]
    _band_slots(m)
    _check_shape("planes4", planes4, (4, m))
    _check_shape("tparams", tparams, (m // 128, 4))
    _on_cuda("dequant_boxes", device)
    return _dequant_boxes("q16", planes4, None, None, tparams, boxes=boxes)


def _planes_qvalid(planes, qvalid):
    device = planes.device
    _check("planes", planes, torch.float32, 2, device)
    _check("qvalid", qvalid, torch.bool, 1, device)
    m = planes.shape[1]
    _band_slots(m)
    if planes.shape[0] < 4:
        raise ValueError(f"planes shape {tuple(planes.shape)} unsupported")
    _check_shape("qvalid", qvalid, (m,))
    return device, m


def tile_boxes(planes, qvalid):
    """Launch dequant_boxes on dequantized planes -> Boxes.

    planes [>= 4, M] f32 (rows x, y, z, r_eff read), qvalid [M] bool,
    contiguous on one CUDA device; 0 < M < 2^24, M % 128 == 0.
    """
    device, _m = _planes_qvalid(planes, qvalid)
    _on_cuda("dequant_boxes", device)
    return _dequant_boxes("planes", planes, qvalid)[2]


def band_jlist(planes, qvalid, tmeta, boxes, w: int):
    """Launch band_jlist -> [M/128, 128] i32 j-lists, byte-equal to
    fused_kernel.build_jlist_banded_reference.

    planes [>= 4, M] f32, qvalid [M] bool, tmeta [M/128, 2] i32 (first
    tile of each tile's structure, its tiles), boxes the Boxes of those
    planes (dequant_boxes), all contiguous on one CUDA device; 0 < M <
    2^24, M % 128 == 0, 1 <= w <= 127.
    """
    device, m = _planes_qvalid(planes, qvalid)
    t = m // 128
    _check("tmeta", tmeta, torch.int32, 2, device)
    _check_shape("tmeta", tmeta, (t, 2))
    for name, b, shape in zip(Boxes._fields, boxes, _box_shapes(t)):
        _check(name, b, torch.float32, len(shape), device)
        _check_shape(name, b, shape)
    if not 1 <= w <= MAX_BAND_W:
        raise ValueError(f"band width {w} outside [1, {MAX_BAND_W}]")
    _on_cuda("band_jlist", device)
    jlist = torch.empty((t, 128), dtype=torch.int32, device=device)
    _launch("band_jlist", device, planes.data_ptr(), qvalid.data_ptr(),
            tmeta.data_ptr(), *(b.data_ptr() for b in boxes),
            jlist.data_ptr(), m, w)
    return jlist


def _cell_batch(packed, group_id):
    """Checks shared by the neighbor phase's launchers: packed [B, N, 4]
    f32 (16-byte aligned) and group_id [B, N] i32, contiguous on one
    device, 1 <= B <= MAX_CELL_BATCH, N >= 1, B*N rounded up to 4 under
    2^31.  Returns (device, B, N)."""
    device = packed.device
    _check("packed", packed, torch.float32, 3, device)
    _check("group_id", group_id, torch.int32, 2, device)
    b, n = group_id.shape
    _check_shape("packed", packed, (b, n, 4))
    if not 1 <= b <= MAX_CELL_BATCH or n == 0:
        raise ValueError(f"group_id shape {(b, n)}: need 1 to "
                         f"{MAX_CELL_BATCH} structures of at least one slot")
    if b * n + (-(b * n) % 4) >= 1 << 31:
        raise ValueError(f"{b * n} slots: too many for one launch")
    if packed.data_ptr() % 16:
        raise ValueError("packed must start on a 16-byte boundary")
    return device, b, n


def cell_keys(packed, group_id, probe: float) -> CellOrder:
    """Launch the list path's cell binning and ordering -> CellOrder,
    bit-equal to neighbors.cell_order_reference (cell_grid, a stable
    torch.sort of its keys and the gathers of packed and group_id).

    packed [B, N, 4] f32 (16-byte aligned), group_id [B, N] i32 (-1 =
    padding), contiguous on one CUDA device; 1 <= B <= MAX_CELL_BATCH.
    One launch count for the two kernels (the binning, then the order);
    the outputs and their scratch (12 bytes a slot twice, and 16 a
    structure) are views of three allocations.
    """
    device, b, n = _cell_batch(packed, group_id)
    _on_cuda("cell_keys", device)
    m = b * n
    wide = torch.empty(5 * m + b, dtype=torch.int64, device=device)
    narrow = torch.empty(4 * b + 3 * m, dtype=torch.int32, device=device)
    sorted_packed = torch.empty((m, 4), dtype=torch.float32, device=device)
    keys, sorted_keys, perm, tmp_keys = wide[:5 * m].split((m, m, m, 2 * m))
    grid, sorted_gid, tmp_slots = narrow.split((4 * b, m, 2 * m))
    h = wide[5 * m:].view(torch.float64)
    max_r = torch.empty(b, dtype=torch.float32, device=device)
    _launch("cell_keys", device, packed.data_ptr(), group_id.data_ptr(),
            keys.data_ptr(), max_r.data_ptr(), h.data_ptr(),
            sorted_keys.data_ptr(), perm.data_ptr(), sorted_packed.data_ptr(),
            sorted_gid.data_ptr(), grid.data_ptr(), tmp_keys.data_ptr(),
            tmp_slots.data_ptr(), b, n, 2.0 * probe)
    return CellOrder(keys, max_r, h, sorted_keys, perm, sorted_packed,
                     sorted_gid)


def neighbor_cells(packed, group_id, max_r, keys, sorted_keys, perm,
                   sorted_packed, sorted_gid, *, probe: float, k: int):
    """Launch the list path's cell-list neighbor phase -> (planes [4, K,
    M4] f32: vx, vy, vz, limit K-major; counts [B*N] i32; max_count 0-d
    i32), byte-equal to neighbors.neighbor_records_reference (per row the
    same records, in another order).

    packed [B, N, 4] f32 and sorted_packed [B*N, 4] f32 (16-byte
    aligned), group_id [B, N] i32 (-1 = padding) and sorted_gid [B*N]
    i32, max_r [B] f32 (each structure's largest real radius), keys
    [B*N] i64, sorted_keys and perm [B*N] i64 (their stable sort),
    sorted_packed and sorted_gid the atoms in that order (packed and
    group_id at perm) - cell_keys' CellOrder - all contiguous on one CUDA
    device; 1 <= B <= MAX_CELL_BATCH, 1 <= k <= N, M4 = B*N rounded up to
    4.
    """
    device, b, n = _cell_batch(packed, group_id)
    m = b * n
    _check("max_r", max_r, torch.float32, 1, device)
    _check_shape("max_r", max_r, (b,))
    for name, t in (("keys", keys), ("sorted_keys", sorted_keys),
                    ("perm", perm)):
        _check(name, t, torch.int64, 1, device)
        _check_shape(name, t, (m,))
    _check("sorted_packed", sorted_packed, torch.float32, 2, device)
    _check_shape("sorted_packed", sorted_packed, (m, 4))
    _check("sorted_gid", sorted_gid, torch.int32, 1, device)
    _check_shape("sorted_gid", sorted_gid, (m,))
    if sorted_packed.data_ptr() % 16:
        raise ValueError("sorted_packed must start on a 16-byte boundary")
    if not 1 <= k <= n:
        raise ValueError(f"k = {k} outside [1, {n}]")
    m4 = m + (-m % 4)
    _on_cuda("neighbor_cells", device)
    planes = torch.empty((4, k, m4), dtype=torch.float32, device=device)
    counts = torch.empty(m, dtype=torch.int32, device=device)
    max_count = torch.empty((), dtype=torch.int32, device=device)
    _launch("neighbor_cells", device, packed.data_ptr(), group_id.data_ptr(),
            keys.data_ptr(), max_r.data_ptr(), sorted_keys.data_ptr(),
            perm.data_ptr(), sorted_packed.data_ptr(), sorted_gid.data_ptr(),
            planes.data_ptr(), counts.data_ptr(), max_count.data_ptr(), b, n,
            k, m4, probe, 2.0 * probe)
    return planes, counts, max_count
