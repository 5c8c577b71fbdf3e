"""Builder API of the PyTorch port.

`SASAOptions` is the reference's own class (`rustsasa_tpu/api.py`, loaded
through `_host`), bound to the port's engine: `process` computes on
CUDA.
"""

from __future__ import annotations

from ._host.api import SASAOptions
from ._host.io.read import read_structure
from ._host.levels import Level, SASAResult
from .ops.engine import calculate_sasa_internal

__all__ = [
    "Level",
    "SASAOptions",
    "SASAResult",
    "calculate_sasa_internal",
    "read_structure",
]
