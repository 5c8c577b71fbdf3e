"""The plain reference's own structure reading, selection and radii.

Reads the first model of a PDB (optionally gzipped) or mmCIF file and
selects atoms as RustSASA does by default: ATOM records only (no
HETATM), no hydrogens, atoms with a blank alternate location plus each
residue's first alternate conformer; radii from the frozen ProtOr table
(`protor.py`), an atom without one being an error.  Residues are keyed
by (chain, serial, insertion code) and listed in the order they first
appear, chain by chain; every residue of the model is listed, also one
that keeps no atom.  Nothing here imports the program.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass

import numpy as np

from .protor import PROTOR_RADII


@dataclass
class Atoms:
    """The first model's atom records, in file order."""

    coords: np.ndarray  # [N, 3] float32
    name: list
    alt: list
    resname: list
    chain: list
    serial: list  # residue serial numbers
    icode: list
    element: list
    hetero: np.ndarray  # [N] bool


@dataclass
class Selection:
    """The atoms whose SASA is computed, and the residues they sum into."""

    index: np.ndarray  # [n] int64 positions of the selected atoms in Atoms
    coords: np.ndarray  # [n, 3] float32
    radii: np.ndarray  # [n] float32 van der Waals radii (no probe)
    residue: np.ndarray  # [n] int64 index into `residues`
    residues: list  # [(chain, serial, icode)] of every residue of the model


def _open_text(path: str) -> str:
    if path.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8", errors="replace") as f:
            return f.read()
    with open(path, encoding="utf-8", errors="replace") as f:
        return f.read()


def _pdb(text: str) -> Atoms:
    rows = []
    for line in text.split("\n"):
        rec = line[:6]
        if rec.startswith("ATOM") or rec == "HETATM":
            rows.append(line.rstrip("\r").ljust(80))
        elif rec.startswith("ENDMDL"):
            break
    c22 = [r[21:22].strip() for r in rows]
    return Atoms(
        coords=np.array([[float(r[30:38]), float(r[38:46]), float(r[46:54])]
                         for r in rows], dtype=np.float32).reshape(-1, 3),
        name=[r[12:16].strip() for r in rows],
        alt=[r[16:17].strip() for r in rows],
        resname=[r[17:20].strip() for r in rows],
        chain=[r[20:22].strip() if c else "" for r, c in zip(rows, c22)],
        serial=[int(r[22:26]) for r in rows],
        icode=[r[26:27].strip() for r in rows],
        element=[r[76:78].strip().upper() for r in rows],
        hetero=np.array([r.startswith("HETATM") for r in rows], dtype=bool),
    )


_TOKEN = re.compile(r"'[^']*'|\"[^\"]*\"|\S+")


def _cif(text: str) -> Atoms:
    lines = text.split("\n")
    i = 0
    while i < len(lines):
        if lines[i].strip() == "loop_" and i + 1 < len(lines) \
                and lines[i + 1].startswith("_atom_site."):
            break
        i += 1
    else:
        raise ValueError("no _atom_site loop")
    i += 1
    cols = []
    while lines[i].startswith("_atom_site."):
        cols.append(lines[i].strip()[len("_atom_site."):])
        i += 1
    rows = []
    while i < len(lines):
        line = lines[i].strip()
        if not line or line.startswith(("#", "_", "loop_", "data_")):
            break
        rows.append([t.strip("'\"") for t in _TOKEN.findall(line)])
        i += 1
    at = {c: k for k, c in enumerate(cols)}

    def col(*names, default=""):
        for n in names:
            if n in at:
                return [("" if r[at[n]] in (".", "?") else r[at[n]])
                        for r in rows]
        return [default] * len(rows)

    model = col("pdbx_PDB_model_num")
    keep = [m == model[0] for m in model] if rows else []
    rows = [r for r, k in zip(rows, keep) if k]
    return Atoms(
        coords=np.array([[float(v) for v in xyz] for xyz in zip(
            col("Cartn_x"), col("Cartn_y"), col("Cartn_z"))],
            dtype=np.float32).reshape(-1, 3),
        name=col("auth_atom_id", "label_atom_id"),
        alt=col("label_alt_id"),
        resname=col("auth_comp_id", "label_comp_id"),
        chain=col("auth_asym_id", "label_asym_id"),
        serial=[int(s) for s in col("auth_seq_id", "label_seq_id")],
        icode=col("pdbx_PDB_ins_code"),
        element=[e.upper() for e in col("type_symbol")],
        hetero=np.array([g == "HETATM" for g in col("group_PDB")],
                        dtype=bool),
    )


def read_atoms(path: str) -> Atoms:
    """The first model's atoms of a PDB, PDB.gz or mmCIF file."""
    text = _open_text(path)
    base = path[:-3] if path.endswith(".gz") else path
    return _cif(text) if base.endswith((".cif", ".mmcif")) else _pdb(text)


def select(atoms: Atoms) -> Selection:
    """RustSASA's default selection of `atoms`, with ProtOr radii."""
    res_of = {}
    residue = np.empty(len(atoms.name), dtype=np.int64)
    chains: dict = {}
    for k, key in enumerate(zip(atoms.chain, atoms.serial, atoms.icode)):
        if key not in res_of:
            res_of[key] = len(res_of)
            chains.setdefault(key[0], []).append(key)
        residue[k] = res_of[key]
    # Each residue keeps its blank-altloc conformers and the first
    # alternate one, by the file position of its first atom.
    first_alt: dict = {}
    for k in range(len(atoms.name)):
        if atoms.alt[k] != "":
            first_alt.setdefault(residue[k], (atoms.resname[k], atoms.alt[k]))
    keep = []
    radii = []
    for k in range(len(atoms.name)):
        alt = atoms.alt[k]
        if alt != "" and first_alt[residue[k]] != (atoms.resname[k], alt):
            continue
        if atoms.element[k] == "":
            raise ValueError(f"atom {k} ({atoms.name[k]}) has no element")
        if atoms.element[k] == "H" or atoms.hetero[k]:
            continue
        r = PROTOR_RADII.get(atoms.resname[k], {}).get(atoms.name[k])
        if r is None:
            raise ValueError(f"no ProtOr radius for {atoms.resname[k]} "
                             f"{atoms.name[k]}")
        keep.append(k)
        radii.append(r)
    order = [key for keys in chains.values() for key in keys]
    slot = {key: s for s, key in enumerate(order)}
    remap = np.array([slot[key] for key in res_of], dtype=np.int64)
    index = np.array(keep, dtype=np.int64)
    return Selection(
        index=index,
        coords=np.ascontiguousarray(atoms.coords[index]),
        radii=np.array(radii, dtype=np.float32),
        residue=remap[residue[index]] if len(index) else index,
        residues=order,
    )
