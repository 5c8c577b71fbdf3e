"""Build, load and launch the port's hand-written CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface and loaded with ctypes: no
PyTorch headers, so a build takes seconds, and the sources build in
parallel (one nvcc each, all started together).  The build happens at
first use, into `build/rustsasa_tpu_torch/` beside the package, keyed by
a hash of the source and flags; nothing is built or imported when this
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

launch_counts = {"fused_count": 0, "list_occlusion": 0}
_count_lock = threading.Lock()
_build_lock = threading.Lock()
_launchers: dict = {}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
# C signature of each kernel's launch function, by source name.
_SIGNATURES = {
    "fused_count": [_VOIDP] * 4 + [_INT] * 2 + [_VOIDP],
    "list_occlusion": [_VOIDP] * 8 + [_INT] * 3 + [_VOIDP],
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


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
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


def fused_count(planes, jlist, sphere):
    """Launch the occlusion-count kernel on the current stream -> [M] i32.

    planes [8, M] f32, jlist [M/128, 128] i32, sphere [P, 4] f32, all
    contiguous on one CUDA device; M a positive multiple of 128 and
    0 < P <= 2048.
    """
    device = planes.device
    if device.type != "cuda":
        raise ValueError(f"fused_count needs CUDA tensors, got {device}")
    _check("planes", planes, torch.float32, 2, device)
    _check("jlist", jlist, torch.int32, 2, device)
    _check("sphere", sphere, torch.float32, 2, device)
    m = planes.shape[1]
    p = sphere.shape[0]
    if planes.shape[0] < 5 or m == 0 or m % 128:
        raise ValueError(f"planes shape {tuple(planes.shape)} unsupported")
    if tuple(jlist.shape) != (m // 128, 128):
        raise ValueError(f"jlist shape {tuple(jlist.shape)} != ({m // 128}, 128)")
    if sphere.shape[1] != 4 or not 0 < p <= MAX_P_PAD:
        raise ValueError(f"sphere shape {tuple(sphere.shape)} unsupported")
    # Rows 0..4 of planes are read with a row stride of M.
    out = torch.empty(m, dtype=torch.int32, device=device)
    launch = _library("fused_count")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = launch(
            planes.data_ptr(), jlist.data_ptr(), sphere.data_ptr(),
            out.data_ptr(), m, p, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_count_launch failed: cudaError {rc}")
    _count("fused_count")
    return out


def list_occlusion(vx, vy, vz, limit, area, sphere, tile_kmax):
    """Launch the list-path occlusion kernel on the current stream ->
    per-atom SASA [N] f32.

    vx, vy, vz, limit [K, N] f32 (K-major), area [N] f32, sphere [P, 4]
    f32, tile_kmax [ceil(N/128)] i32, all contiguous on one CUDA device;
    N, K, P positive.  Any number of sphere points.
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
    out = torch.empty(n, dtype=torch.float32, device=device)
    launch = _library("list_occlusion")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = launch(
            vx.data_ptr(), vy.data_ptr(), vz.data_ptr(), limit.data_ptr(),
            area.data_ptr(), sphere.data_ptr(), tile_kmax.data_ptr(),
            out.data_ptr(), n, k, p, stream,
        )
    if rc != 0:
        raise RuntimeError(f"list_occlusion_launch failed: cudaError {rc}")
    _count("list_occlusion")
    return out
