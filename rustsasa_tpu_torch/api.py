"""Public builder-style API.

The counterpart of SASAOptions<T> (reference: src/options.rs:59-76,
496-619).  Same defaults, same with_* builder surface, one `process` entry
point; the level is a parameter rather than a zero-sized type.  `process`
computes on the port's engine on `device`: "cuda" by default, which
raises on a host without CUDA (no silent fallback), or "cpu" when asked
for with `SASAOptions(device="cpu")` or `.with_device("cpu")`, where the
plain-torch kernels run.

Example:
    from rustsasa_tpu_torch import SASAOptions, Level, read_structure
    s = read_structure("tests/data/pdbs/example.cif")
    result = SASAOptions(level=Level.RESIDUE).with_n_points(200).process(s)
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .constants import DEFAULT_N_POINTS, DEFAULT_PROBE_RADIUS
from .io.read import read_structure
from .io.structure import Structure
from .levels import (
    AtomSelection,
    Level,
    SASAResult,
    aggregate,
    build_selection,
)
from .ops.engine import calculate_sasa_internal
from .radii import RadiiConfig, load_radii_from_file

__all__ = [
    "Level",
    "SASAOptions",
    "SASAResult",
    "calculate_sasa_internal",
    "read_structure",
]


@dataclass(frozen=True)
class SASAOptions:
    """Configuration for a SASA computation (defaults: options.rs:498-510)."""

    level: Level = Level.RESIDUE
    probe_radius: float = DEFAULT_PROBE_RADIUS
    n_points: int = DEFAULT_N_POINTS
    include_hydrogens: bool = False
    radii_config: RadiiConfig | None = None
    allow_vdw_fallback: bool = False
    include_hetatms: bool = False
    read_radii_from_occupancy: bool = False
    device: str = "cuda"

    # Builder surface mirroring the reference's with_* methods.
    def with_probe_radius(self, radius: float) -> "SASAOptions":
        return replace(self, probe_radius=radius)

    def with_n_points(self, n_points: int) -> "SASAOptions":
        return replace(self, n_points=n_points)

    def with_include_hydrogens(self, include: bool) -> "SASAOptions":
        return replace(self, include_hydrogens=include)

    def with_include_hetatms(self, include: bool) -> "SASAOptions":
        return replace(self, include_hetatms=include)

    def with_allow_vdw_fallback(self, allow: bool) -> "SASAOptions":
        return replace(self, allow_vdw_fallback=allow)

    def with_read_radii_from_occupancy(self, enabled: bool) -> "SASAOptions":
        return replace(self, read_radii_from_occupancy=enabled)

    def with_radii_file(self, path: str) -> "SASAOptions":
        return replace(self, radii_config=load_radii_from_file(path))

    def with_radii_config(self, config: RadiiConfig) -> "SASAOptions":
        return replace(self, radii_config=config)

    def with_device(self, device: str) -> "SASAOptions":
        return replace(self, device=device)

    # Convenience constructors (reference: options.rs:565-587).
    @staticmethod
    def atom_level() -> "SASAOptions":
        return SASAOptions(level=Level.ATOM)

    @staticmethod
    def residue_level() -> "SASAOptions":
        return SASAOptions(level=Level.RESIDUE)

    @staticmethod
    def chain_level() -> "SASAOptions":
        return SASAOptions(level=Level.CHAIN)

    @staticmethod
    def protein_level() -> "SASAOptions":
        return SASAOptions(level=Level.PROTEIN)

    def build_selection(self, structure: Structure) -> AtomSelection:
        return build_selection(
            structure,
            self.level,
            radii_config=self.radii_config,
            allow_vdw_fallback=self.allow_vdw_fallback,
            include_hydrogens=self.include_hydrogens,
            include_hetatms=self.include_hetatms,
            read_radii_from_occupancy=self.read_radii_from_occupancy,
        )

    def process(self, structure: Structure) -> SASAResult:
        """Compute SASA at the configured level (reference: options.rs:606-618)."""
        return self.process_with_selection(structure)[0]

    def process_with_selection(
        self, structure: Structure
    ) -> tuple[SASAResult, AtomSelection]:
        """process() plus the AtomSelection used - callers that write
        results back into a structure (b-factor column) need the selection
        to map filtered atom results onto the full atom table."""
        sel = self.build_selection(structure)
        atom_sasa = calculate_sasa_internal(
            sel.coords,
            sel.radii,
            group_ids=sel.group_ids,
            probe_radius=self.probe_radius,
            n_points=self.n_points,
            device=self.device,
        )
        return aggregate(sel, atom_sasa, self.level), sel
