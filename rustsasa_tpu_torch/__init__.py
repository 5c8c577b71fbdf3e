"""rustsasa_tpu_torch — the Shrake-Rupley SASA engine on PyTorch and CUDA.

A port of `rustsasa_tpu` (JAX/Pallas on a TPU) to an NVIDIA H100.  The
host code (native parser, selection, packers, emit, radii, levels,
serialization, api and batch front ends) is the reference package's own
source, loaded without JAX (`_host.py`).  The device path is PyTorch with
two hand-written CUDA kernels: the occlusion count of the fused wires
(`ops/csrc/fused_count.cu`) and the neighbor-list occlusion
(`ops/csrc/list_occlusion.cu`).

The engine takes every input the JAX engine takes; see ROADMAP.md for
the entry points and kernels still to port.
"""

from .api import Level, SASAOptions, calculate_sasa_internal, read_structure
from .batch import BatchedSasaEngine, SasaParams, process_directory

__all__ = [
    "BatchedSasaEngine",
    "Level",
    "SASAOptions",
    "SasaParams",
    "calculate_sasa_internal",
    "process_directory",
    "read_structure",
]
