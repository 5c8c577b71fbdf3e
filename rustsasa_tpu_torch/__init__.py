"""rustsasa_tpu_torch — the Shrake-Rupley SASA engine on PyTorch and CUDA.

A port of `rustsasa_tpu` (JAX/Pallas on a TPU) to an NVIDIA H100, with
the reference's public surface: `SASAOptions`, structure I/O, result
levels and serializers, radii, the batched engine, directory batch
(`process_directory`), DCD trajectories (`trajectory`), the CLI (`cli`),
the FreeSASA quality gate (`scripts.quality_gate`) and the corpus bench
(`bench`).  Every entry point computes on "cuda" unless the caller asks
for "cpu", where the plain-torch kernels run; without CUDA the default
raises.

The host code (native parser, selection, packers, emit, radii, levels,
serialization, api and batch front ends) is this package's own copy of
the reference's; it builds and loads its own native library
(`native/`).  The device path is PyTorch with hand-written CUDA kernels
in `ops/csrc/`: the occlusion count of the fused wires
(`fused_count.cu`), the neighbor-list occlusion (`list_occlusion.cu`)
and the kernels of the count-kernel studies and kernel experiments
(`scripts/`).
"""

from .api import SASAOptions
from .batch import process_directory
from .constants import (
    DEFAULT_N_POINTS,
    DEFAULT_PROBE_RADIUS,
    POLAR_AMINO_ACIDS,
)
from .io.read import StructureReadError, parse_structure, read_structure
from .io.serialize import (
    sasa_result_to_bfactors,
    sasa_result_to_json,
    sasa_result_to_xml,
)
from .io.structure import Structure
from .levels import (
    ChainResult,
    Level,
    ProteinResult,
    ResidueResult,
    SASAResult,
    serialize_chain_id,
)
from .ops.engine import BatchedSasaEngine, SasaParams, calculate_sasa_internal
from .radii import (
    RadiusMissingError,
    VanDerWaalsMissingError,
    get_protor_radius,
    get_radius,
    get_vdw_radius,
    load_radii_from_file,
    parse_radii_config,
)

__version__ = "0.1.0"

__all__ = [
    "SASAOptions",
    "Level",
    "SASAResult",
    "ResidueResult",
    "ChainResult",
    "ProteinResult",
    "Structure",
    "StructureReadError",
    "read_structure",
    "parse_structure",
    "serialize_chain_id",
    "sasa_result_to_json",
    "sasa_result_to_xml",
    "sasa_result_to_bfactors",
    "BatchedSasaEngine",
    "SasaParams",
    "calculate_sasa_internal",
    "process_directory",
    "DEFAULT_N_POINTS",
    "DEFAULT_PROBE_RADIUS",
    "POLAR_AMINO_ACIDS",
    "RadiusMissingError",
    "VanDerWaalsMissingError",
    "get_protor_radius",
    "get_radius",
    "get_vdw_radius",
    "load_radii_from_file",
    "parse_radii_config",
    "__version__",
]
