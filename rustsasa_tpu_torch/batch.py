"""Directory batch of the PyTorch port: the proteome-throughput pipeline.

`process_directory` is the reference's own pipeline
(`rustsasa_tpu/batch.py`, loaded through `_host`), running on the port's
engine.  Pass `engine=BatchedSasaEngine(params, device=...)` to choose
the device; without one it builds a CUDA engine.
"""

from __future__ import annotations

from ._host.batch import BatchReport, process_directory
from .ops.engine import BatchedSasaEngine, SasaParams

__all__ = [
    "BatchReport",
    "BatchedSasaEngine",
    "SasaParams",
    "process_directory",
]
