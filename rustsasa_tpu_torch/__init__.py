"""rustsasa_tpu_torch — the Shrake-Rupley SASA engine on PyTorch and CUDA.

A port of `rustsasa_tpu` (JAX/Pallas on a TPU) to an NVIDIA H100.  The
host code (native parser, selection, packers, emit, radii, levels,
serialization, api and batch front ends) is the reference package's own
source, loaded without JAX (`_host.py`).  The device path is PyTorch with
a hand-written CUDA occlusion-count kernel (`ops/csrc/fused_count.cu`).

This package covers the residue-level directory batch on the banded q13
and q16 wires; see ROADMAP.md for what is still to port.
"""

from .api import Level, SASAOptions, calculate_sasa_internal, read_structure
from .batch import BatchedSasaEngine, SasaParams, process_directory
from .ops.engine import UnsupportedInSlice

__all__ = [
    "BatchedSasaEngine",
    "Level",
    "SASAOptions",
    "SasaParams",
    "UnsupportedInSlice",
    "calculate_sasa_internal",
    "process_directory",
    "read_structure",
]
