"""Build, load and launch the port's hand-written CUDA kernels.

The sources in `csrc/` are compiled by `nvcc` for `sm_90a` into one
shared library with a plain C interface and loaded with ctypes: no
PyTorch headers, so a build takes seconds.  The build happens at first
use, into `build/rustsasa_tpu_torch/` beside the package, keyed by a hash
of the sources and flags; nothing is built or imported when this module
is imported.  Every launch is counted in `launch_counts`, so a run can
show that its work went through the kernel.
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

launch_counts = {"fused_count": 0}
_count_lock = threading.Lock()
_build_lock = threading.Lock()
_lib = None


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


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


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


def build() -> BuildInfo:
    """Compile csrc/*.cu into the keyed shared library (once)."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"librustsasa_kernels_{h.hexdigest()[:16]}.so")
    log_path = out + ".log"
    if os.path.exists(out):
        with open(log_path, encoding="utf-8") as f:
            return BuildInfo(out, 0.0, f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    with open(log_path, "w", encoding="utf-8") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return BuildInfo(out, seconds, proc.stdout + proc.stderr)


def _library():
    global _lib
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(build().path)
            lib.fused_count_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.fused_count_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


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
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fused_count_launch(
            planes.data_ptr(), jlist.data_ptr(), sphere.data_ptr(),
            out.data_ptr(), m, p, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_count_launch failed: cudaError {rc}")
    _count("fused_count")
    return out
