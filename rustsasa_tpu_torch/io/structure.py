"""In-memory structure model.

Host-side SoA atom table + a light hierarchy (chain -> residue -> conformer)
replicating the grouping semantics of the reference's structure library
(pdbtbx, used via reference: src/options.rs:151-463):

  * chains are unique by id, ordered by first appearance;
  * residues are unique by (serial_number, insertion_code) within a chain,
    ordered by first appearance;
  * conformers are unique by (residue_name, alt_loc) within a residue,
    ordered by first appearance; SASA processing uses only the FIRST
    conformer of each residue (reference: options.rs:162,255,333,433);
  * only the first model of a multi-model file is kept (FreeSASA-compatible).

The hierarchy holds integer indices into the flat atom table; all numeric
data stays in numpy arrays ready for device upload.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class AtomTable:
    """Struct-of-arrays atom records for one model.

    String columns use fixed-width numpy unicode dtypes (U4/U8) rather than
    object arrays: vectorized selection and factorization over millions of
    atoms never touches per-atom Python objects.
    """

    coords: np.ndarray  # [N, 3] float32
    serial: np.ndarray  # [N] int64 atom serial number
    name: np.ndarray  # [N] U8, atom name e.g. "CA"
    alt_loc: np.ndarray  # [N] U4, '' when absent
    resname: np.ndarray  # [N] U8
    chain_id: np.ndarray  # [N] U4
    res_serial: np.ndarray  # [N] int64 residue sequence number
    icode: np.ndarray  # [N] U4, insertion code, '' when absent
    occupancy: np.ndarray  # [N] float32
    bfactor: np.ndarray  # [N] float32
    element: np.ndarray  # [N] U4, uppercase symbol ('' if unknown)
    hetero: np.ndarray  # [N] bool, HETATM flag
    # Optional interned codes (first-appearance dense int32), produced by
    # the native parser; the selection layer derives them when absent.
    chain_code: np.ndarray | None = None
    resname_code: np.ndarray | None = None
    name_code: np.ndarray | None = None
    alt_code: np.ndarray | None = None
    icode_code: np.ndarray | None = None

    def __len__(self) -> int:
        return self.coords.shape[0]

    @staticmethod
    def empty() -> "AtomTable":
        return AtomTable(
            coords=np.zeros((0, 3), np.float32),
            serial=np.zeros(0, np.int64),
            name=np.empty(0, dtype="U8"),
            alt_loc=np.empty(0, dtype="U4"),
            resname=np.empty(0, dtype="U8"),
            chain_id=np.empty(0, dtype="U4"),
            res_serial=np.zeros(0, np.int64),
            icode=np.empty(0, dtype="U4"),
            occupancy=np.zeros(0, np.float32),
            bfactor=np.zeros(0, np.float32),
            element=np.empty(0, dtype="U4"),
            hetero=np.zeros(0, bool),
        )


@dataclass
class Conformer:
    name: str  # residue name
    alt_loc: str  # '' when absent
    atom_indices: list[int] = field(default_factory=list)


@dataclass
class Residue:
    serial_number: int
    insertion_code: str
    conformers: list[Conformer] = field(default_factory=list)

    @property
    def name(self) -> str:
        """Name of the first conformer (reference: pdbtbx Residue::name)."""
        return self.conformers[0].name if self.conformers else ""

    def atom_indices(self) -> list[int]:
        """All atom indices across conformers (for b-factor write-back)."""
        out: list[int] = []
        for c in self.conformers:
            out.extend(c.atom_indices)
        return out


@dataclass
class Chain:
    id: str
    residues: list[Residue] = field(default_factory=list)


@dataclass
class Structure:
    """One parsed structure: flat atom table + lazy hierarchy views.

    The hierarchy (a per-atom Python walk) is only materialized when needed
    - structure writers and b-factor write-back.  The compute path uses
    vectorized selection over the flat table and never builds it.
    """

    atoms: AtomTable
    source_path: str = ""
    format: str = ""  # 'pdb' or 'cif'
    _chains: list[Chain] | None = None

    @property
    def chains(self) -> list[Chain]:
        if self._chains is None:
            self._chains = build_hierarchy(self.atoms)
        return self._chains

    def n_atoms(self) -> int:
        return len(self.atoms)

    def iter_hierarchy_atom_indices(self):
        """Atom indices in hierarchy traversal order (pdbtbx atoms() order)."""
        for chain in self.chains:
            for residue in chain.residues:
                for conformer in residue.conformers:
                    yield from conformer.atom_indices


def build_hierarchy(table: AtomTable) -> list[Chain]:
    """Group a flat atom table into the chain/residue/conformer hierarchy."""
    chains: list[Chain] = []
    chain_lookup: dict[str, Chain] = {}
    res_lookup: dict[tuple[str, int, str], Residue] = {}
    conf_lookup: dict[tuple[str, int, str, str, str], Conformer] = {}

    chain_ids = table.chain_id
    res_serials = table.res_serial
    icodes = table.icode
    resnames = table.resname
    alt_locs = table.alt_loc

    for i in range(len(table)):
        cid = chain_ids[i]
        chain = chain_lookup.get(cid)
        if chain is None:
            chain = Chain(id=cid)
            chain_lookup[cid] = chain
            chains.append(chain)
        rkey = (cid, int(res_serials[i]), icodes[i])
        residue = res_lookup.get(rkey)
        if residue is None:
            residue = Residue(serial_number=rkey[1], insertion_code=rkey[2])
            res_lookup[rkey] = residue
            chain.residues.append(residue)
        ckey = (*rkey, resnames[i], alt_locs[i])
        conformer = conf_lookup.get(ckey)
        if conformer is None:
            conformer = Conformer(name=resnames[i], alt_loc=alt_locs[i])
            conf_lookup[ckey] = conformer
            residue.conformers.append(conformer)
        conformer.atom_indices.append(i)
    return chains


# Element inference from atom names, used when the element column is absent
# or blank (mirrors pdbtbx's loose-mode fallback).
_TWO_LETTER_ELEMENTS = {
    "HE", "LI", "BE", "NE", "NA", "MG", "AL", "SI", "CL", "AR", "CA", "SC",
    "TI", "CR", "MN", "FE", "CO", "NI", "CU", "ZN", "GA", "GE", "AS", "SE",
    "BR", "KR", "RB", "SR", "ZR", "NB", "MO", "TC", "RU", "RH", "PD", "AG",
    "CD", "IN", "SN", "SB", "TE", "XE", "CS", "BA", "HG", "PB", "BI",
}


def infer_element(raw_name_field: str) -> str:
    """Infer the element symbol from a PDB atom-name FIELD (columns 13-16).

    PDB convention: the element is right-justified in columns 13-14, so a
    leading blank means a one-letter element (" CA " is a C-alpha carbon)
    while a non-blank first column means a two-letter element ("FE  ",
    "CA  " as calcium) or a digit-prefixed hydrogen ("1HB2").
    """
    field4 = raw_name_field[:4].ljust(4)
    if field4[0] == " " or field4[0].isdigit():
        stripped = field4.strip().lstrip("0123456789")
        return stripped[0].upper() if stripped else ""
    two = field4[:2].upper()
    if two in _TWO_LETTER_ELEMENTS:
        return two
    stripped = field4.strip()
    return stripped[0].upper() if stripped else ""
