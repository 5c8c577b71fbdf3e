"""rustsasa_tpu_torch — the Shrake-Rupley SASA engine on PyTorch and CUDA.

A port of `rustsasa_tpu` (JAX/Pallas on a TPU) to an NVIDIA H100.  The
host code (native parser, selection, packers, emit, radii, levels,
serialization, api and batch front ends) is this package's own copy of
the reference's; it builds and loads its own native library
(`native/`).  The device path is PyTorch with hand-written CUDA kernels
in `ops/csrc/`: the occlusion count of the fused wires
(`fused_count.cu`), the neighbor-list occlusion (`list_occlusion.cu`)
and the kernels of the count-kernel studies and kernel experiments
(`scripts/`).

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
