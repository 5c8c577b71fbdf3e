"""PDB-format reader/writer.

Vectorized fixed-column parsing: ATOM/HETATM lines are packed into an
[N, 80] byte matrix and every field is sliced as a numpy column batch -
no per-line Python loop on the hot path.  Parsing is permissive ("Loose"
in the reference's terms, main.rs:185-188): non-coordinate records are
ignored, malformed numeric fields fall back to per-row repair instead of
failing the file, and files with broken header records (SEQADV, odd
space groups) parse fine because only coordinate records are read.
"""

from __future__ import annotations

import numpy as np

from .structure import AtomTable, Structure, infer_element


class PDBParseError(ValueError):
    pass


def _field_float(mat: np.ndarray, lo: int, hi: int, default: float = 0.0) -> np.ndarray:
    """Parse a fixed-width float column; per-row fallback on bad cells."""
    raw = np.ascontiguousarray(mat[:, lo:hi]).view(f"S{hi - lo}").ravel()
    try:
        return raw.astype(np.float64)
    except ValueError:
        out = np.full(len(raw), default, dtype=np.float64)
        for i, cell in enumerate(raw):
            try:
                out[i] = float(cell)
            except ValueError:
                pass
        return out


def _field_int(mat: np.ndarray, lo: int, hi: int) -> np.ndarray:
    raw = np.ascontiguousarray(mat[:, lo:hi]).view(f"S{hi - lo}").ravel()
    try:
        return raw.astype(np.int64)
    except ValueError:
        from .hybrid36 import decode as h36_decode

        out = np.zeros(len(raw), dtype=np.int64)
        for i, cell in enumerate(raw):
            try:
                out[i] = int(cell)
            except ValueError:
                try:
                    # Hybrid-36 extended numbering (A0000.. for >99999
                    # serials, as written by cctbx/Phenix and by our own
                    # write_pdb).
                    out[i] = h36_decode(cell.decode(), hi - lo)
                except ValueError:
                    # Overflowed serials ("*****"): fall back to the
                    # previous value + 1 so ordering survives.
                    out[i] = out[i - 1] + 1 if i else 0
        return out


def _field_str(mat: np.ndarray, lo: int, hi: int) -> np.ndarray:
    raw = np.ascontiguousarray(mat[:, lo:hi]).view(f"S{hi - lo}").ravel()
    return np.char.strip(raw.astype(str))


def parse_pdb(content: str | bytes, source_path: str = "") -> Structure:
    """Parse PDB text into a Structure (first model only)."""
    if isinstance(content, str):
        content = content.encode("utf-8", "replace")
    lines = content.split(b"\n")

    atom_lines: list[bytes] = []
    for line in lines:
        rec = line[:6]
        if rec.startswith(b"ATOM") or rec == b"HETATM":
            atom_lines.append(line)
        elif rec.startswith(b"ENDMDL"):
            # Keep only the first model (FreeSASA-compatible choice; the
            # reference's test corpus has no multi-model files).
            break

    if not atom_lines:
        return Structure(
            atoms=AtomTable.empty(), source_path=source_path, format="pdb"
        )

    n = len(atom_lines)
    mat = np.zeros((n, 80), dtype="S1")
    packed = np.array(atom_lines, dtype="S80")
    mat = packed.view("S1").reshape(n, 80)
    # Replace NUL padding with spaces so numeric conversions work.
    mat = np.where(mat == b"", b" ", mat)

    # PDB fixed columns (1-based spec -> 0-based slices).
    record = np.ascontiguousarray(mat[:, 0:6]).view("S6").ravel()
    hetero = np.char.startswith(record, b"HETATM")
    serial = _field_int(mat, 6, 11)
    raw_name = np.ascontiguousarray(mat[:, 12:16]).view("S4").ravel().astype(str)
    name = np.char.strip(raw_name)
    alt_loc = _field_str(mat, 16, 17)
    resname = _field_str(mat, 17, 20)
    # Columns 21-22: the spec's chainID is column 22 only, but column 21
    # is blank in conforming files, so reading both supports the
    # two-character chain ids our writer emits for multi-char chains
    # (the cctbx/iotbx convention).  Guard: column 21 joins the chain
    # only when column 22 itself is non-blank — a 4-char resname
    # spilling into column 21 of a CHAIN-LESS file (CHARMM-style) must
    # not fabricate a chain id.  (With both columns non-blank the two
    # conventions are inherently ambiguous; ours follows cctbx.)
    c22 = _field_str(mat, 21, 22)
    chain_id = np.where(c22 == "", c22, _field_str(mat, 20, 22))
    res_serial = _field_int(mat, 22, 26)
    icode = _field_str(mat, 26, 27)
    x = _field_float(mat, 30, 38)
    y = _field_float(mat, 38, 46)
    z = _field_float(mat, 46, 54)
    occupancy = _field_float(mat, 54, 60, default=1.0)
    bfactor = _field_float(mat, 60, 66, default=0.0)
    element = np.char.upper(_field_str(mat, 76, 78))

    # Element fallback: infer from the raw atom-name field where blank.
    missing = element == ""
    if missing.any():
        element = element.astype("U4")
        for i in np.nonzero(missing)[0]:
            element[i] = infer_element(raw_name[i])

    table = AtomTable(
        coords=np.stack([x, y, z], axis=1).astype(np.float32),
        serial=serial,
        name=name,
        alt_loc=alt_loc,
        resname=resname,
        chain_id=chain_id,
        res_serial=res_serial,
        icode=icode,
        occupancy=occupancy.astype(np.float32),
        bfactor=bfactor.astype(np.float32),
        element=element,
        hetero=hetero,
    )
    return Structure(atoms=table, source_path=source_path, format="pdb")


def write_pdb(structure: Structure, bfactors: np.ndarray | None = None) -> str:
    """Serialize a Structure back to PDB text.

    bfactors: optional [N] replacement B-factor column (SASA write-back,
    reference: io.rs:20-64 + pdbtbx::save).
    """
    from .hybrid36 import encode as h36
    from .hybrid36 import max_value as h36_max

    t = structure.atoms
    bf = t.bfactor if bfactors is None else np.asarray(bfactors)
    out: list[str] = []
    for chain in structure.chains:
        # Multi-character chain ids (mmCIF-origin structures) occupy the
        # always-blank column 21 plus the spec's column 22, the common
        # two-char extension (parse_pdb reads both columns back).  Ids
        # longer than two characters cannot round-trip through PDB's
        # fixed columns; truncation is the documented lossy case — use
        # cif output for such structures.
        cid = (chain.id or " ")[:2].rjust(2)
        last_idx = None
        for residue in chain.residues:
            rs = int(residue.serial_number)
            # Beyond even hybrid-36: clamp (degraded but valid output,
            # like the old 9999 clamp) rather than abort the write.
            rs_field = (
                f"{rs:>4}" if rs <= 9999 else h36(min(rs, h36_max(4)), 4)
            )
            for conformer in residue.conformers:
                for i in conformer.atom_indices:
                    name = t.name[i]
                    # Standard alignment: element right-justified in 13-14.
                    if len(name) < 4 and len(t.element[i]) < 2:
                        name_field = f" {name:<3}"
                    else:
                        name_field = f"{name:<4}"
                    record = "HETATM" if t.hetero[i] else "ATOM  "
                    serial = int(t.serial[i])
                    sf = (
                        f"{serial:>5}" if serial <= 99999
                        else h36(min(serial, h36_max(5)), 5)
                    )
                    out.append(
                        f"{record}{sf} {name_field}"
                        f"{t.alt_loc[i] or ' '}{t.resname[i]:>3}"
                        f"{cid}{rs_field}"
                        f"{residue.insertion_code or ' '}   "
                        f"{t.coords[i, 0]:8.3f}{t.coords[i, 1]:8.3f}"
                        f"{t.coords[i, 2]:8.3f}{t.occupancy[i]:6.2f}"
                        f"{bf[i]:6.2f}          {t.element[i]:>2}"
                    )
                    last_idx = i
        if last_idx is not None:
            out.append(
                f"TER   {h36(min(int(t.serial[last_idx]) + 1, h36_max(5)), 5)}      "
                f"{t.resname[last_idx]:>3}{cid}"
                f"{h36(min(int(chain.residues[-1].serial_number), h36_max(4)), 4)}"
                f"{chain.residues[-1].insertion_code or ' '}"
            )
    out.append("END")
    return "\n".join(out) + "\n"
