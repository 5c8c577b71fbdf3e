"""MD trajectory streaming SASA (the mdsasa-bolt workload) on the port's
engine.

Static topology + radii are resolved once; frame coordinate blocks stream
through the batched engine, every frame of a block one structure of the
same fused chunk, so a block is one launch of the count kernel
(`ops/csrc/fused_count.cu`) on `device`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..api import SASAOptions
from ..io.read import read_structure
from ..levels import Level, _residue_sums
from ..ops.engine import CHUNK_SLOT_BUDGET, BatchedSasaEngine, SasaParams
from .dcd import DCDHeader, iter_frame_blocks, read_dcd, write_dcd

__all__ = [
    "DCDHeader",
    "read_dcd",
    "write_dcd",
    "iter_frame_blocks",
    "TrajectoryResult",
    "compute_trajectory_sasa",
]


@dataclass
class TrajectoryResult:
    n_frames: int
    n_atoms: int
    # Per-frame totals [F]; per-frame per-residue [F, R] when residue level.
    totals: np.ndarray
    residue_values: np.ndarray | None
    residue_names: list[str] | None


def compute_trajectory_sasa(
    topology_path: str,
    dcd_path: str,
    options: SASAOptions | None = None,
    *,
    block: int | None = None,
    device=None,
) -> TrajectoryResult:
    """Per-frame SASA over a DCD trajectory.

    topology_path: PDB/mmCIF supplying atom identities and radii; the DCD
    must have the same atom count and order (the MDAnalysis convention the
    reference's mdsasa-bolt follows).

    Frame blocks pipeline: block i+1 is read from disk and packed while
    block i's device queue drains (enqueue/collect split), so wall time is
    max(device, ingest) - the same overlap as directory batch mode.
    block defaults to however many frames fill one fused chunk (atom-slot
    budget / padded frame size).  device defaults to `options.device`
    ("cuda", which raises without CUDA; "cpu" runs the plain-torch
    kernels).
    """
    options = options or SASAOptions(level=Level.RESIDUE)
    structure = read_structure(topology_path)
    sel = options.build_selection(structure)
    if block is None:
        slots = max(128, -(-sel.coords.shape[0] // 128) * 128)
        block = max(1, min(1024, CHUNK_SLOT_BUDGET // slots))

    engine = BatchedSasaEngine(
        SasaParams(
            probe_radius=options.probe_radius, n_points=options.n_points
        ),
        device=options.device if device is None else device,
    )

    totals: list[float] = []
    residue_rows: list[np.ndarray] = []
    n_atoms_traj = None

    def consume(pending):
        for atom_sasa in pending.collect():
            totals.append(float(atom_sasa.sum()))
            if options.level is Level.RESIDUE:
                # Vectorized per-frame residue sums (no per-frame Python
                # result objects - a 10k-frame GPCRmd run would otherwise
                # churn millions of ResidueResult allocations).
                residue_rows.append(_residue_sums(sel, atom_sasa))

    in_flight = None
    for _, _, coords in iter_frame_blocks(dcd_path, block=block):
        n_atoms_traj = coords.shape[1]
        if n_atoms_traj != structure.n_atoms():
            raise ValueError(
                f"trajectory has {n_atoms_traj} atoms but topology has "
                f"{structure.n_atoms()}"
            )
        frames = [
            (
                np.ascontiguousarray(coords[i][sel.atom_indices]),
                sel.radii,
                sel.group_ids,
            )
            for i in range(coords.shape[0])
        ]
        pending = engine.enqueue(frames)
        if in_flight is not None:
            consume(in_flight)
        in_flight = pending
    if in_flight is not None:
        consume(in_flight)

    residue_values = (
        np.stack(residue_rows) if residue_rows else None
    )
    residue_names = (
        [str(n) for n in sel.res_name] if residue_rows else None
    )
    return TrajectoryResult(
        n_frames=len(totals),
        n_atoms=n_atoms_traj or 0,
        totals=np.array(totals, dtype=np.float32),
        residue_values=residue_values,
        residue_names=residue_names,
    )
