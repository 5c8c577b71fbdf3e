"""Build, load and launch the port's hand-written CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface and loaded with ctypes: no
PyTorch headers, so a build takes seconds, and the sources build in
parallel (one nvcc each, all started together).  The build happens at
first use, into `build/rustsasa_tpu_torch/` beside the package, keyed by
a hash of the source, the shared `.cuh` headers and the flags; nothing
is built or imported when this
module is imported.  Every launch is counted in `launch_counts`, so a run
can show that its work went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "rustsasa_tpu_torch",
)
# --fmad=false: counts are held bit-exact against the reference, whose
# margins round every multiply and add separately.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
MAX_P_PAD = 2048
# Sphere points per thread and slices per CTA of the count kernels
# (csrc/count_tile.cuh kMaxK, kSlices).
MAX_K = 16
SLICES = 4
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
    "fused_count": 0, "list_occlusion": 0, "pair64_count": 0,
    "nibble_count": 0, "saturation_count": 0, "micro_count": 0,
    "reach_count": 0, "maxplus_count": 0, "ke_stream": 0, "ke_maxplus": 0,
    "ke_bf16": 0, "ke_mxu": 0,
}
_count_lock = threading.Lock()
_build_lock = threading.Lock()
_launchers: dict = {}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
# C signature of each kernel's launch function, by source name.
_SIGNATURES = {
    "fused_count": [_VOIDP] * 4 + [_INT] * 2 + [_VOIDP],
    "list_occlusion": [_VOIDP] * 9 + [_INT] * 6 + [_VOIDP],
    "pair64_count": [_VOIDP] * 5 + [_INT] * 2 + [_VOIDP],
    "nibble_count": [_VOIDP] * 6 + [_INT] * 2 + [_VOIDP],
    "saturation_count": [_VOIDP] * 5 + [_INT] * 3 + [_VOIDP],
    "micro_count": [_VOIDP] * 4 + [_INT] * 3 + [_VOIDP],
    "reach_count": [_VOIDP] * 5 + [_INT] * 3 + [_VOIDP],
    "maxplus_count": [_VOIDP] * 4 + [_INT] * 2 + [_VOIDP],
    **{name: [_VOIDP] * 5 + [_INT] * 3 + [_VOIDP] for name in KE_VARIANTS},
}


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
    for name in _SIGNATURES:
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
            for lib_name, info in build().items():
                if lib_name in _launchers:
                    continue
                lib = ctypes.CDLL(info.path)
                fn = getattr(lib, f"{lib_name}_launch")
                fn.argtypes = _SIGNATURES[lib_name]
                fn.restype = ctypes.c_int
                _launchers[lib_name] = fn
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


def fused_count(planes, jlist, sphere):
    """Launch the occlusion-count kernel on the current stream -> [M] i32.

    planes [8, M] f32, jlist [M/128, 128] i32, sphere [P, 4] f32, all
    contiguous on one CUDA device; M a positive multiple of 128 and
    0 < P <= 2048.
    """
    device, m, p = _count_inputs("fused_count", planes, sphere,
                                 {"jlist": jlist})
    # Rows 0..4 of planes are read with a row stride of M.
    out = torch.empty(m, dtype=torch.int32, device=device)
    _launch("fused_count", device, planes.data_ptr(), jlist.data_ptr(),
            sphere.data_ptr(), out.data_ptr(), m, p)
    return out


def pair64_count(planes, jlist_a, jmask_b, sphere):
    """Launch the per-half admission count kernel -> [M] i32.

    As fused_count, but lanes 0-63 of a tile stream the groups of the
    entry's mask A ((mask_a << 16) | j in jlist_a) and lanes 64-127 those
    of mask B (the low 16 bits of the same cell of jmask_b).
    """
    device, m, p = _count_inputs("pair64_count", planes, sphere,
                                 {"jlist_a": jlist_a, "jmask_b": jmask_b})
    out = torch.empty(m, dtype=torch.int32, device=device)
    _launch("pair64_count", device, planes.data_ptr(), jlist_a.data_ptr(),
            jmask_b.data_ptr(), sphere.data_ptr(), out.data_ptr(), m, p)
    return out


def nibble_count(planes, jl, w1, w2, sphere):
    """Launch the nibble-list count kernel -> [M] i32.

    As fused_count, but an entry is (gcount << 16) | j and its admitted
    group ids are the first gcount 4-bit nibbles of w1 (0-7) and w2
    (8-15) in the same cells.
    """
    device, m, p = _count_inputs("nibble_count", planes, sphere,
                                 {"jl": jl, "w1": w1, "w2": w2})
    out = torch.empty(m, dtype=torch.int32, device=device)
    _launch("nibble_count", device, planes.data_ptr(), jl.data_ptr(),
            w1.data_ptr(), w2.data_ptr(), sphere.data_ptr(), out.data_ptr(),
            m, p)
    return out


def saturation_count(planes, jlist, sphere, check_every: int):
    """Launch the tile-saturation count kernel -> (counts [M] i32,
    streamed [M/128] i32).

    As fused_count, but after every check_every-th entry a CTA whose
    points of the current pass are all occluded for all 128 atoms leaves
    that pass's entry loop; streamed[tile] sums the entries each pass
    went through.
    """
    device, m, p = _count_inputs("saturation_count", planes, sphere,
                                 {"jlist": jlist})
    if check_every < 1:
        raise ValueError(f"check_every {check_every} < 1")
    out = torch.empty(m, dtype=torch.int32, device=device)
    streamed = torch.empty(m // 128, dtype=torch.int32, device=device)
    _launch("saturation_count", device, planes.data_ptr(), jlist.data_ptr(),
            sphere.data_ptr(), out.data_ptr(), streamed.data_ptr(), m, p,
            check_every)
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

    As fused_count, with the loop over admitted groups reshaped by
    `variant` (one of MICRO_VARIANTS); every variant gives the same counts.
    """
    code = variant_code("micro_count", variant, MICRO_VARIANTS)
    device, m, p = _count_inputs("micro_count", planes, sphere,
                                 {"jlist": jlist})
    out = torch.empty(m, dtype=torch.int32, device=device)
    _launch("micro_count", device, planes.data_ptr(), jlist.data_ptr(),
            sphere.data_ptr(), out.data_ptr(), m, p, code)
    return out


def reach_count(planes, jlist, sphere, variant: str):
    """Launch the reach-test count kernel -> (counts [M] i32, executed
    [M/128] i32).

    Every live entry's j-tile (entry & 0xFFFF; mask bits ignored) is
    streamed under the reach test of `variant` (one of REACH_VARIANTS);
    executed[tile] sums the j-rows streamed over all point passes.
    """
    code = variant_code("reach_count", variant, REACH_VARIANTS)
    device, m, p = _count_inputs("reach_count", planes, sphere,
                                 {"jlist": jlist})
    out = torch.empty(m, dtype=torch.int32, device=device)
    executed = torch.empty(m // 128, dtype=torch.int32, device=device)
    _launch("reach_count", device, planes.data_ptr(), jlist.data_ptr(),
            sphere.data_ptr(), out.data_ptr(), executed.data_ptr(), m, p,
            code)
    return out, executed


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
