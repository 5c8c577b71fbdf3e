"""Atomic radius resolution.

Implements the same radius-precedence chain as the reference
(reference: options.rs:81-116, utils.rs:40-56, consts.rs:31-91):

    occupancy column  >  user radii file  >  embedded ProtOr  >
    element van der Waals fallback (if allowed)  >  error

The van der Waals table is the Alvarez 2013 consistent vdW radii set
("A cartography of the van der Waals territories", Dalton Trans. 42, 8617),
which is the table the reference inherits from pdbtbx
(`element.atomic_radius().van_der_waals`).  Verified against the
reference golden per-atom SASA values (C=1.77, N=1.66, O=1.50, S=1.89).
"""

from __future__ import annotations

import numpy as np

from .data.protor import PROTOR_RADII

# Alvarez 2013 van der Waals radii in Angstroms, element symbol -> radius.
# Elements without a published value are simply absent (lookup returns None,
# mirroring pdbtbx's Option<f64>).
VDW_RADII: dict[str, float] = {
    "H": 1.2, "HE": 1.43, "LI": 2.12, "BE": 1.98, "B": 1.91, "C": 1.77,
    "N": 1.66, "O": 1.5, "F": 1.46, "NE": 1.58, "NA": 2.5, "MG": 2.51,
    "AL": 2.25, "SI": 2.19, "P": 1.9, "S": 1.89, "CL": 1.82, "AR": 1.83,
    "K": 2.73, "CA": 2.62, "SC": 2.58, "TI": 2.46, "V": 2.42, "CR": 2.45,
    "MN": 2.45, "FE": 2.44, "CO": 2.4, "NI": 2.4, "CU": 2.38, "ZN": 2.39,
    "GA": 2.32, "GE": 2.29, "AS": 1.88, "SE": 1.82, "BR": 1.86, "KR": 2.25,
    "RB": 3.21, "SR": 2.84, "Y": 2.75, "ZR": 2.52, "NB": 2.56, "MO": 2.45,
    "TC": 2.44, "RU": 2.46, "RH": 2.44, "PD": 2.15, "AG": 2.53, "CD": 2.49,
    "IN": 2.43, "SN": 2.42, "SB": 2.47, "TE": 1.99, "I": 2.04, "XE": 2.06,
    "CS": 3.48, "BA": 3.03, "LA": 2.98, "CE": 2.88, "PR": 2.92, "ND": 2.95,
    "SM": 2.9, "EU": 2.87, "GD": 2.83, "TB": 2.79, "DY": 2.87, "HO": 2.81,
    "ER": 2.83, "TM": 2.79, "YB": 2.8, "LU": 2.74, "HF": 2.63, "TA": 2.53,
    "W": 2.57, "RE": 2.49, "OS": 2.48, "IR": 2.41, "PT": 2.29, "AU": 2.32,
    "HG": 2.45, "TL": 2.47, "PB": 2.6, "BI": 2.54, "AC": 2.8, "TH": 2.93,
    "PA": 2.88, "U": 2.71, "NP": 2.82, "PU": 2.81, "AM": 2.83, "CM": 3.05,
    "BK": 3.4, "CF": 3.05, "ES": 2.7,
}

RadiiConfig = dict[str, dict[str, float]]


def parse_radii_config(content: str) -> RadiiConfig:
    """Parse a FreeSASA-format radii config into {residue: {atom: radius}}.

    Same grammar as the reference parser (reference: consts.rs:31-81):
    a ``types:`` section of ``TYPE RADIUS [POLARITY]`` rows followed by an
    ``atoms:`` section of ``RESIDUE ATOM TYPE`` rows.  Unknown types and
    malformed rows are skipped silently, comments (#) and ``name:`` ignored.
    """
    types: dict[str, float] = {}
    atoms: RadiiConfig = {}
    in_types = False
    in_atoms = False
    for raw in content.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("name:"):
            continue
        if line == "types:":
            in_types, in_atoms = True, False
            continue
        if line == "atoms:":
            in_types, in_atoms = False, True
            continue
        parts = line.split()
        if in_types and len(parts) >= 2:
            try:
                types[parts[0]] = float(parts[1])
            except ValueError:
                pass
        elif in_atoms and len(parts) >= 3 and parts[2] in types:
            atoms.setdefault(parts[0], {})[parts[1]] = types[parts[2]]
    return atoms


def load_radii_from_file(path: str) -> RadiiConfig:
    """Load a FreeSASA-format radii config file (reference: consts.rs:83-88)."""
    with open(path, encoding="utf-8") as f:
        return parse_radii_config(f.read())


def get_protor_radius(residue_name: str, atom_name: str) -> float | None:
    """Embedded ProtOr lookup (reference: utils.rs:35-37)."""
    inner = PROTOR_RADII.get(residue_name)
    if inner is None:
        return None
    return inner.get(atom_name)


def get_radius(
    residue_name: str,
    atom_name: str,
    radii_config: RadiiConfig | None = None,
) -> float | None:
    """Custom-config-first radius lookup (reference: utils.rs:40-56)."""
    if radii_config is not None:
        inner = radii_config.get(residue_name)
        if inner is not None:
            r = inner.get(atom_name)
            if r is not None:
                return r
    return get_protor_radius(residue_name, atom_name)


def get_vdw_radius(element: str) -> float | None:
    """Element van der Waals radius (Alvarez 2013), or None if unknown."""
    return VDW_RADII.get(element.upper())


class RadiusMissingError(ValueError):
    """No radius found and vdW fallback disabled (reference: options.rs:480-484)."""

    def __init__(self, residue_name: str, atom_name: str, element: str):
        self.residue_name = residue_name
        self.atom_name = atom_name
        self.element = element
        super().__init__(
            f"Radius not found for residue '{residue_name}' atom '{atom_name}' "
            f"of type '{element}'. This error can be ignored if you pass "
            "--allow-vdw-fallback on the CLI or allow_vdw_fallback=True in the API."
        )


class VanDerWaalsMissingError(ValueError):
    """Element has no vdW radius in the table (reference: options.rs:470-471)."""

    def __init__(self, element: str):
        self.element = element
        super().__init__(f"Van der Waals radius missing for element '{element}'")


def resolve_radii(
    resnames: np.ndarray,
    atom_names: np.ndarray,
    elements: np.ndarray,
    occupancy: np.ndarray,
    *,
    radii_config: RadiiConfig | None = None,
    allow_vdw_fallback: bool = False,
    read_radii_from_occupancy: bool = False,
) -> np.ndarray:
    """Vectorized radius resolution for a batch of atoms.

    Applies the full precedence chain per atom and raises
    RadiusMissingError / VanDerWaalsMissingError exactly where the
    reference does (reference: options.rs:83-103).
    """
    # Delegates to the grouped resolver the selection pipeline uses
    # (levels._resolve_radii_grouped) so there is exactly ONE radius
    # precedence implementation; this wrapper only builds the pair key.
    if read_radii_from_occupancy:
        return np.asarray(occupancy, dtype=np.float32)
    from .levels import _resolve_radii_grouped

    rn = np.asarray(resnames, dtype=str)
    an = np.asarray(atom_names, dtype=str)
    pair_key = np.char.add(np.char.add(rn, "\x00"), an)
    return _resolve_radii_grouped(
        pair_key, rn, an, np.asarray(elements, dtype=str),
        np.asarray(occupancy),
        radii_config=radii_config,
        allow_vdw_fallback=allow_vdw_fallback,
        read_radii_from_occupancy=False,
    )
