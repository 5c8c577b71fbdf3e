"""mmCIF reader/writer (the _atom_site category).

Parses the atom_site loop with whole-block tokenization (one split over the
entire block, reshaped [N, n_cols]) instead of per-line Python parsing.
Only coordinate data is read, which makes the parser robust to the long
tail of header categories.  Mirrors the reference's pdbtbx usage:
auth_* identifiers preferred over label_* (chain "A" in the reference
test corpus is auth_asym_id), '.'/'?' treated as absent, first model only.
"""

from __future__ import annotations

import numpy as np

from .structure import AtomTable, Structure, infer_element


class CIFParseError(ValueError):
    pass


def _tok_missing(values: np.ndarray) -> np.ndarray:
    return (values == ".") | (values == "?")


def _pick(cols: dict[str, int], *names: str) -> int | None:
    for n in names:
        if n in cols:
            return cols[n]
    return None


def parse_cif(content: str | bytes, source_path: str = "") -> Structure:
    if isinstance(content, bytes):
        content = content.decode("utf-8", "replace")
    lines = content.splitlines()

    # Locate the atom_site loop: a `loop_` whose first tags are _atom_site.*
    i = 0
    n_lines = len(lines)
    cols: dict[str, int] = {}
    data_rows: list[str] = []
    while i < n_lines:
        if lines[i].strip() == "loop_":
            j = i + 1
            tags: list[str] = []
            while j < n_lines and lines[j].strip().startswith("_"):
                tags.append(lines[j].strip().split()[0])
                j += 1
            if tags and tags[0].startswith("_atom_site."):
                cols = {
                    t[len("_atom_site."):]: idx for idx, t in enumerate(tags)
                }
                while j < n_lines:
                    row = lines[j].strip()
                    if not row or row.startswith(("#", "_", "loop_", "data_")):
                        break
                    data_rows.append(row)
                    j += 1
                break
            i = j
        else:
            i += 1

    if not data_rows or not cols:
        return Structure(
            atoms=AtomTable.empty(), source_path=source_path, format="cif"
        )

    n_cols = len(cols)
    tokens = np.array("\n".join(data_rows).split())
    if tokens.size % n_cols != 0:
        # Rare: quoted values containing whitespace; repair row by row.
        import shlex

        fixed: list[list[str]] = []
        for row in data_rows:
            parts = row.split()
            if len(parts) != n_cols:
                parts = shlex.split(row)
            if len(parts) == n_cols:
                fixed.append(parts)
        tokens = np.array([t for row in fixed for t in row])
        if tokens.size == 0 or tokens.size % n_cols != 0:
            raise CIFParseError(
                f"atom_site loop has ragged rows in {source_path or '<memory>'}"
            )
    grid = tokens.reshape(-1, n_cols)

    def col(*names: str, default: str | None = None) -> np.ndarray | None:
        idx = _pick(cols, *names)
        if idx is None:
            if default is None:
                return None
            return np.full(grid.shape[0], default, dtype=object)
        return grid[:, idx]

    group = col("group_PDB", default="ATOM")
    model = col("pdbx_PDB_model_num")
    keep = np.ones(grid.shape[0], dtype=bool)
    if model is not None:
        keep &= model == model[0]
    grid = grid[keep]

    def kcol(*names: str, default: str | None = None) -> np.ndarray | None:
        c = col(*names, default=default)
        return None if c is None else c[keep]

    group = group[keep]
    serial_raw = kcol("id")
    name = kcol("auth_atom_id", "label_atom_id", default="")
    element = kcol("type_symbol")
    alt = kcol("label_alt_id", default=".")
    resname = kcol("auth_comp_id", "label_comp_id", default="UNK")
    chain = kcol("auth_asym_id", "label_asym_id", default="A")
    res_serial_raw = kcol("auth_seq_id", "label_seq_id", default="0")
    icode = kcol("pdbx_PDB_ins_code", default=".")
    x = kcol("Cartn_x")
    y = kcol("Cartn_y")
    z = kcol("Cartn_z")
    occ = kcol("occupancy", default="1.0")
    bf = kcol("B_iso_or_equiv", default="0.0")

    if x is None or y is None or z is None:
        raise CIFParseError(f"atom_site loop lacks coordinates in {source_path}")

    n = grid.shape[0]

    def to_float(arr: np.ndarray, default: float) -> np.ndarray:
        vals = np.where(_tok_missing(arr), str(default), arr)
        try:
            return vals.astype(np.float64)
        except ValueError:
            out = np.full(n, default)
            for k, v in enumerate(vals):
                try:
                    out[k] = float(v)
                except ValueError:
                    pass
            return out

    def to_int(arr: np.ndarray | None, default: int = 0) -> np.ndarray:
        if arr is None:
            return np.arange(n, dtype=np.int64)
        vals = np.where(_tok_missing(arr), str(default), arr)
        try:
            return vals.astype(np.int64)
        except ValueError:
            out = np.zeros(n, dtype=np.int64)
            for k, v in enumerate(vals):
                try:
                    out[k] = int(float(v))
                except ValueError:
                    out[k] = out[k - 1] + 1 if k else default
            return out

    def clean_str(arr: np.ndarray, width: int = 8) -> np.ndarray:
        out = np.where(_tok_missing(arr), "", arr)
        # Strip mmCIF quoting (leading/trailing quote characters only).
        return np.char.strip(out.astype(f"U{width}"), "'\"")

    name_clean = clean_str(name)
    if element is None:
        element_clean = np.array(
            [infer_element(f" {nm}" if len(nm) < 4 else nm) for nm in name_clean],
            dtype="U4",
        )
    else:
        element_clean = np.char.upper(clean_str(element, 4))

    table = AtomTable(
        coords=np.stack(
            [to_float(x, 0.0), to_float(y, 0.0), to_float(z, 0.0)], axis=1
        ).astype(np.float32),
        serial=to_int(serial_raw),
        name=name_clean,
        alt_loc=clean_str(alt, 4),
        resname=clean_str(resname),
        chain_id=clean_str(chain, 4),
        res_serial=to_int(res_serial_raw),
        icode=clean_str(icode, 4),
        occupancy=to_float(occ, 1.0).astype(np.float32),
        bfactor=to_float(bf, 0.0).astype(np.float32),
        element=element_clean,
        hetero=(group == "HETATM"),
    )
    return Structure(atoms=table, source_path=source_path, format="cif")


def write_cif(structure: Structure, bfactors: np.ndarray | None = None) -> str:
    """Serialize to a minimal valid mmCIF with an atom_site loop."""
    t = structure.atoms
    bf = t.bfactor if bfactors is None else np.asarray(bfactors)
    out = [
        "data_rustsasa_tpu",
        "#",
        "loop_",
        "_atom_site.group_PDB",
        "_atom_site.id",
        "_atom_site.type_symbol",
        "_atom_site.label_atom_id",
        "_atom_site.label_alt_id",
        "_atom_site.label_comp_id",
        "_atom_site.auth_asym_id",
        "_atom_site.auth_seq_id",
        "_atom_site.pdbx_PDB_ins_code",
        "_atom_site.Cartn_x",
        "_atom_site.Cartn_y",
        "_atom_site.Cartn_z",
        "_atom_site.occupancy",
        "_atom_site.B_iso_or_equiv",
        "_atom_site.pdbx_PDB_model_num",
    ]
    serial = 0
    for chain in structure.chains:
        for residue in chain.residues:
            for conformer in residue.conformers:
                for i in conformer.atom_indices:
                    serial += 1
                    out.append(
                        f"{'HETATM' if t.hetero[i] else 'ATOM'} {serial} "
                        f"{t.element[i] or '?'} {t.name[i] or '?'} "
                        f"{t.alt_loc[i] or '.'} {t.resname[i] or '?'} "
                        f"{chain.id or '?'} {residue.serial_number} "
                        f"{residue.insertion_code or '?'} "
                        f"{t.coords[i, 0]:.3f} {t.coords[i, 1]:.3f} "
                        f"{t.coords[i, 2]:.3f} {t.occupancy[i]:.2f} "
                        f"{bf[i]:.2f} 1"
                    )
    out.append("#")
    return "\n".join(out) + "\n"
