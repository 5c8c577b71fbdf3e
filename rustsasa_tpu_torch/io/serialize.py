"""Result serialization: JSON, XML, and structure b-factor write-back.

Output schemas are wire-compatible with the reference's serde output
(reference: src/utils/io.rs, src/structures/atomic.rs:63-70):

  JSON (externally tagged):   {"Residue": [{"serial_number": ..., ...}]}
  XML (quick-xml style):      repeated <Residue>...</Residue> roots
  PDB/CIF: SASA values stamped into the B-factor column of the original
  structure (reference: io.rs:20-64).

Floats are rendered with shortest-f32 round-trip representation to match
serde_json's output for f32 values.
"""

from __future__ import annotations

from xml.sax.saxutils import escape

import numpy as np

from ..levels import Level, SASAResult
from .structure import Structure


class SerializationError(ValueError):
    """Result does not fit the structure (reference: CLIError::ProteinSerialization)."""


def _f32_repr(x: float) -> str:
    """Shortest round-trip decimal for an f32 (serde_json f32 formatting)."""
    return np.format_float_positional(
        np.float32(x), unique=True, trim="0"
    ).rstrip(".") or "0.0"


def _f32_json(x: float) -> str:
    s = _f32_repr(x)
    return s if ("." in s or "e" in s or "E" in s) else s + ".0"


def _json_str(s: str) -> str:
    import json

    return json.dumps(s)


def sasa_result_to_json(result: SASAResult) -> str:
    """Serialize to the reference's externally-tagged JSON (io.rs:11-13)."""
    if result.level is Level.ATOM:
        body = ",".join(_f32_json(v) for v in result.atoms)
        return f'{{"Atom":[{body}]}}'
    if result.level is Level.RESIDUE:
        items = ",".join(
            "{"
            f'"serial_number":{r.serial_number},'
            f'"insertion_code":{_json_str(r.insertion_code)},'
            f'"value":{_f32_json(r.value)},'
            f'"name":{_json_str(r.name)},'
            f'"is_polar":{"true" if r.is_polar else "false"},'
            f'"chain_id":{_json_str(r.chain_id)}'
            "}"
            for r in result.residues
        )
        return f'{{"Residue":[{items}]}}'
    if result.level is Level.CHAIN:
        items = ",".join(
            f'{{"name":{_json_str(c.name)},"value":{_f32_json(c.value)}}}'
            for c in result.chains
        )
        return f'{{"Chain":[{items}]}}'
    if result.level is Level.PROTEIN:
        p = result.protein
        return (
            f'{{"Protein":{{"global_total":{_f32_json(p.global_total)},'
            f'"polar_total":{_f32_json(p.polar_total)},'
            f'"non_polar_total":{_f32_json(p.non_polar_total)}}}}}'
        )
    raise SerializationError(f"unknown level {result.level}")


def sasa_result_to_xml(result: SASAResult) -> str:
    """Serialize to quick-xml-compatible XML (io.rs:16-18).

    quick-xml renders the externally tagged enum as repeated variant-named
    root elements; we match that shape for parity.
    """
    if result.level is Level.ATOM:
        return "".join(f"<Atom>{_f32_repr(v)}</Atom>" for v in result.atoms)
    if result.level is Level.RESIDUE:
        return "".join(
            "<Residue>"
            f"<serial_number>{r.serial_number}</serial_number>"
            f"<insertion_code>{escape(r.insertion_code)}</insertion_code>"
            f"<value>{_f32_repr(r.value)}</value>"
            f"<name>{escape(r.name)}</name>"
            f"<is_polar>{'true' if r.is_polar else 'false'}</is_polar>"
            f"<chain_id>{escape(r.chain_id)}</chain_id>"
            "</Residue>"
            for r in result.residues
        )
    if result.level is Level.CHAIN:
        return "".join(
            "<Chain>"
            f"<name>{escape(c.name)}</name>"
            f"<value>{_f32_repr(c.value)}</value>"
            "</Chain>"
            for c in result.chains
        )
    if result.level is Level.PROTEIN:
        p = result.protein
        return (
            "<Protein>"
            f"<global_total>{_f32_repr(p.global_total)}</global_total>"
            f"<polar_total>{_f32_repr(p.polar_total)}</polar_total>"
            f"<non_polar_total>{_f32_repr(p.non_polar_total)}</non_polar_total>"
            "</Protein>"
        )
    raise SerializationError(f"unknown level {result.level}")


def _bfactors_from_selection(structure, result, sel, bf):
    """Vectorized residue/chain write-back via the AtomSelection.

    The hierarchy-walk fallback below builds per-atom Python objects
    (~10-15 ms/structure); when the result was computed FROM this
    selection (batch/CLI always pass it), the same stamping is a pair of
    numpy joins: every table atom whose (chain, res_serial, icode) key
    matches selection residue k gets that residue's (or its chain's)
    value - identical semantics to the walk, which stamps every atom of
    each hierarchy residue including filtered-out ones (parity test:
    tests/test_io.py).  Returns None when the result doesn't line up
    with the selection (foreign result objects -> checked walk).
    """
    t = structure.atoms
    if result.level is Level.PROTEIN:
        bf[:] = result.protein.global_total
        return bf
    if result.level not in (Level.RESIDUE, Level.CHAIN):
        return None

    n_res = sel.n_residues
    if n_res == 0:
        return None
    if result.level is Level.RESIDUE:
        if len(result.residues) != n_res:
            return None
        # Foreign-result guard: the walk validates per-residue serials
        # and raises; the fast path validates the same thing vectorized
        # and falls back to the checked walk on any mismatch.
        serials = np.fromiter(
            (r.serial_number for r in result.residues), np.int64,
            count=n_res,
        )
        if not np.array_equal(serials, np.asarray(sel.res_serial)):
            return None
        res_vals = np.fromiter(
            (r.value for r in result.residues), np.float32, count=n_res
        )
    else:
        if len(result.chains) != len(sel.chain_ids):
            return None
        if any(
            c.name != cid for c, cid in zip(result.chains, sel.chain_ids)
        ):
            return None
        chain_vals = np.fromiter(
            (c.value for c in result.chains), np.float32,
            count=len(result.chains),
        )
        res_vals = chain_vals[sel.res_chain_idx]

    # Fixed wide key dtypes: wider than any parser emits (chain U4,
    # icode U4 today), so neither a foreign selection's ids nor a future
    # parser widening can truncate into a false key match.
    cdt = np.dtype("U8")
    idt = np.dtype("U8")
    chain_arr = np.asarray(sel.chain_ids, dtype=cdt)
    res_keys = _pack_rows(
        chain_arr[sel.res_chain_idx],
        np.asarray(sel.res_serial, dtype=np.int64),
        np.asarray(sel.res_icode, dtype=idt),
    )
    atom_keys = _pack_rows(
        t.chain_id.astype(cdt),
        np.asarray(t.res_serial, dtype=np.int64),
        t.icode.astype(idt),
    )
    order = np.argsort(res_keys, kind="stable")
    pos = np.searchsorted(res_keys[order], atom_keys)
    pos = np.minimum(pos, n_res - 1)
    hit = res_keys[order[pos]] == atom_keys
    if not hit.all():
        return None  # atoms outside the selection's residue set
    bf[:] = res_vals[order[pos]]
    return bf


def _pack_rows(*cols: np.ndarray) -> np.ndarray:
    from ..levels import _rows

    return _rows(*cols)


def sasa_result_to_bfactors(
    structure: Structure, result: SASAResult, selection=None
) -> np.ndarray:
    """Compute the replacement B-factor column for write-back (io.rs:20-64).

    Returns an [N] array over ALL atoms of the structure in table order.
    At atom level, `selection` (an AtomSelection) maps the filtered result
    vector back onto the full structure; excluded atoms (H/HETATM/alt-loc)
    are written as 0.0, matching the excluded-residue-0.0 semantics of the
    residue level.  (The reference indexes the full atom list positionally
    and would panic on a filtered result, io.rs:25-29 - deliberate
    improvement, not a parity break.)
    """
    t = structure.atoms
    bf = np.array(t.bfactor, dtype=np.float32, copy=True)

    if result.level is Level.ATOM:
        if selection is not None:
            bf[:] = 0.0
            bf[selection.atom_indices] = np.asarray(
                result.atoms, dtype=np.float32
            )
            return bf
        order = list(structure.iter_hierarchy_atom_indices())
        if len(result.atoms) < len(order):
            raise SerializationError(
                f"atom result length {len(result.atoms)} < structure atom "
                f"count {len(order)} (excluded atoms cannot be written "
                f"back); pass the selection to map filtered results"
            )
        for pos, i in enumerate(order):
            bf[i] = result.atoms[pos]
        return bf

    if selection is not None:
        fast = _bfactors_from_selection(structure, result, selection, bf)
        if fast is not None:
            return fast

    if result.level is Level.RESIDUE:
        it = iter(result.residues)
        for chain in structure.chains:
            for residue in chain.residues:
                try:
                    r = next(it)
                except StopIteration as e:
                    raise SerializationError(
                        "residue result count does not match structure"
                    ) from e
                if r.serial_number != residue.serial_number:
                    raise SerializationError(
                        f"residue serial mismatch: {r.serial_number} != "
                        f"{residue.serial_number}"
                    )
                for i in residue.atom_indices():
                    bf[i] = r.value
        return bf

    if result.level is Level.CHAIN:
        if len(result.chains) != len(structure.chains):
            raise SerializationError("chain result count does not match structure")
        for c_res, chain in zip(result.chains, structure.chains):
            if c_res.name != chain.id:
                raise SerializationError(
                    f"chain name mismatch: {c_res.name} != {chain.id}"
                )
            for residue in chain.residues:
                for i in residue.atom_indices():
                    bf[i] = c_res.value
        return bf

    if result.level is Level.PROTEIN:
        bf[:] = result.protein.global_total
        return bf

    raise SerializationError(f"unknown level {result.level}")


def _json_float_col(values: np.ndarray) -> np.ndarray:
    """Vectorized f32 -> JSON number strings (%.9g: exact f32 round-trip)."""
    vals = np.asarray(values, dtype=np.float64)
    s = np.char.mod("%.9g", vals)
    plain = np.char.isdigit(np.char.replace(s, "-", ""))
    return np.where(plain, np.char.add(s, ".0"), s)


def _json_str_col(values: np.ndarray) -> np.ndarray:
    """Vectorized string column -> JSON string literals (incl. quotes)."""
    import json

    arr = np.asarray(values).astype("U16")
    uq, inv = np.unique(arr, return_inverse=True)
    esc = np.array([json.dumps(str(u)) for u in uq], dtype="U32")
    return esc[inv]


def fast_selection_json(sel, atom_sasa: np.ndarray, level: Level) -> str:
    """Hot-path JSON straight from selection arrays (no result objects).

    Identical schema to sasa_result_to_json; float rendering uses %.9g
    (exact f32 round-trip, not necessarily shortest-decimal).
    """
    from ..constants import POLAR_AMINO_ACIDS
    from ..levels import _residue_sums

    if level is Level.ATOM:
        return '{"Atom":[' + ",".join(_json_float_col(atom_sasa)) + "]}"

    if level is Level.RESIDUE:
        sums = _residue_sums(sel, atom_sasa)
        if sel.n_residues == 0:
            return '{"Residue":[]}'
        polar = np.isin(
            sel.res_name.astype("U8"), sorted(POLAR_AMINO_ACIDS)
        )
        chain_col = np.array(sel.chain_ids, dtype="U16")[sel.res_chain_idx]
        parts = np.char.add('{"serial_number":', sel.res_serial.astype("U20"))
        parts = np.char.add(parts, ',"insertion_code":')
        parts = np.char.add(parts, _json_str_col(sel.res_icode))
        parts = np.char.add(parts, ',"value":')
        parts = np.char.add(parts, _json_float_col(sums))
        parts = np.char.add(parts, ',"name":')
        parts = np.char.add(parts, _json_str_col(sel.res_name))
        parts = np.char.add(parts, ',"is_polar":')
        parts = np.char.add(
            parts, np.where(polar, "true", "false").astype("U5")
        )
        parts = np.char.add(parts, ',"chain_id":')
        parts = np.char.add(parts, _json_str_col(chain_col))
        parts = np.char.add(parts, "}")
        return '{"Residue":[' + ",".join(parts) + "]}"

    # Chain/protein payloads are tiny; go through the generic path.
    from ..levels import aggregate

    return sasa_result_to_json(aggregate(sel, atom_sasa, level))


def _xml_str_col(values: np.ndarray) -> np.ndarray:
    arr = np.asarray(values).astype("U16")
    uq, inv = np.unique(arr, return_inverse=True)
    esc = np.array([escape(str(u)) for u in uq], dtype="U48")
    return esc[inv]


def fast_selection_xml(sel, atom_sasa: np.ndarray, level: Level) -> str:
    """Hot-path XML straight from selection arrays (quick-xml shapes)."""
    from ..constants import POLAR_AMINO_ACIDS
    from ..levels import _residue_sums, aggregate

    if level is Level.ATOM:
        vals = _json_float_col(atom_sasa)
        return "".join(
            np.char.add(np.char.add("<Atom>", vals), "</Atom>")
        )
    if level is Level.RESIDUE:
        sums = _residue_sums(sel, atom_sasa)
        if sel.n_residues == 0:
            return ""
        polar = np.isin(sel.res_name.astype("U8"), sorted(POLAR_AMINO_ACIDS))
        chain_col = np.array(sel.chain_ids, dtype="U16")[sel.res_chain_idx]
        parts = np.char.add(
            "<Residue><serial_number>", sel.res_serial.astype("U20")
        )
        parts = np.char.add(parts, "</serial_number><insertion_code>")
        parts = np.char.add(parts, _xml_str_col(sel.res_icode))
        parts = np.char.add(parts, "</insertion_code><value>")
        parts = np.char.add(parts, _json_float_col(sums))
        parts = np.char.add(parts, "</value><name>")
        parts = np.char.add(parts, _xml_str_col(sel.res_name))
        parts = np.char.add(parts, "</name><is_polar>")
        parts = np.char.add(parts, np.where(polar, "true", "false").astype("U5"))
        parts = np.char.add(parts, "</is_polar><chain_id>")
        parts = np.char.add(parts, _xml_str_col(chain_col))
        parts = np.char.add(parts, "</chain_id></Residue>")
        return "".join(parts)
    return sasa_result_to_xml(aggregate(sel, atom_sasa, level))


def parse_json_result(content: str) -> SASAResult:
    """Read back an externally tagged JSON result (for tests/tools)."""
    import json

    from ..levels import ChainResult, ProteinResult, ResidueResult

    data = json.loads(content)
    if "Atom" in data:
        return SASAResult(
            level=Level.ATOM, atoms=np.asarray(data["Atom"], np.float32)
        )
    if "Residue" in data:
        return SASAResult(
            level=Level.RESIDUE,
            residues=[ResidueResult(**r) for r in data["Residue"]],
        )
    if "Chain" in data:
        return SASAResult(
            level=Level.CHAIN, chains=[ChainResult(**c) for c in data["Chain"]]
        )
    if "Protein" in data:
        return SASAResult(
            level=Level.PROTEIN, protein=ProteinResult(**data["Protein"])
        )
    raise SerializationError("unrecognized SASA result JSON")
