"""Faithful SASA write-back: splice B-factors into the source file text.

The reference clones the parsed PDB and saves through pdbtbx, preserving
the file's record structure (src/utils/io.rs:20-64).  Re-emitting from
our SoA tables would instead normalize away everything the parser does
not model (headers, REMARKs, CONECT, element charge columns, exotic
alignment).  This module goes one better than the reference: it re-reads
the ORIGINAL source text and rewrites only the B-factor field of each
coordinate record, so the output differs from the input in exactly that
column.  When the source text is unavailable (structure built in memory)
or does not line up with the atom table (a parser the splicer does not
mirror), callers fall back to the from-scratch writers in pdb.py/cif.py.
"""

from __future__ import annotations

import gzip
import os
import re

import numpy as np

from .structure import Structure


def load_source_text(structure: Structure) -> str | None:
    path = structure.source_path
    if not path or not os.path.isfile(path):
        return None
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rb") as f:
                content = f.read()
        else:
            with open(path, "rb") as f:
                content = f.read()
    except OSError:
        return None
    return content.decode("utf-8", "replace")


def _fmt_bf(value: float) -> str:
    """B-factor in 6 columns; degrade precision rather than overflow."""
    for spec in ("6.2f", "6.1f", "6.0f"):
        s = format(float(value), spec)
        if len(s) <= 6:
            return s.rjust(6)
    return format(float(value), ".6g")[:6].rjust(6)


def writeback_pdb(structure: Structure, bfactors: np.ndarray) -> str | None:
    """Splice bfactors into the source PDB's ATOM/HETATM lines.

    Returns None (caller falls back to write_pdb) when the source is
    missing or its coordinate-record count doesn't match the table —
    the record predicate and first-model-only rule mirror parse_pdb.
    """
    if structure.format != "pdb":
        return None
    text = load_source_text(structure)
    if text is None:
        return None
    bf = np.asarray(bfactors, dtype=np.float64)
    lines = text.split("\n")
    k = 0
    splicing = True
    for idx, line in enumerate(lines):
        rec = line[:6]
        if splicing and (rec.startswith("ATOM") or rec == "HETATM"):
            if k >= len(bf):
                return None
            padded = line.ljust(66)
            lines[idx] = padded[:60] + _fmt_bf(bf[k]) + padded[66:]
            k += 1
        elif rec.startswith("ENDMDL"):
            # Only the first model is parsed (parse_pdb); later models
            # pass through untouched.
            splicing = False
    if k != len(bf):
        return None
    return "\n".join(lines)


_TOKEN_RE = re.compile(r"\S+")


def writeback_cif(structure: Structure, bfactors: np.ndarray) -> str | None:
    """Splice bfactors into the source mmCIF's atom_site loop.

    Mirrors parse_cif's loop location and first-model filter; returns
    None when the B_iso_or_equiv column is absent, a row tokenizes
    raggedly (quoted whitespace), or counts don't line up.
    """
    if structure.format != "cif":
        return None
    text = load_source_text(structure)
    if text is None:
        return None
    bf = np.asarray(bfactors, dtype=np.float64)
    lines = text.split("\n")
    n_lines = len(lines)

    # Locate the atom_site loop exactly like parse_cif.
    i = 0
    tags: list[str] = []
    start = end = -1
    while i < n_lines:
        if lines[i].strip() == "loop_":
            j = i + 1
            tags = []
            while j < n_lines and lines[j].strip().startswith("_"):
                tags.append(lines[j].strip().split()[0])
                j += 1
            if tags and tags[0].startswith("_atom_site."):
                start = j
                while j < n_lines:
                    row = lines[j].strip()
                    if not row or row.startswith(("#", "_", "loop_", "data_")):
                        break
                    j += 1
                end = j
                break
            i = j
        else:
            i += 1
    if start < 0:
        return None
    cols = {t[len("_atom_site."):]: idx for idx, t in enumerate(tags)}
    bf_col = cols.get("B_iso_or_equiv")
    if bf_col is None:
        return None
    model_col = cols.get("pdbx_PDB_model_num")
    n_cols = len(tags)

    first_model: str | None = None
    k = 0
    for idx in range(start, end):
        spans = [m.span() for m in _TOKEN_RE.finditer(lines[idx])]
        if len(spans) != n_cols:
            return None  # quoted whitespace rows: fall back to writer
        toks = [lines[idx][a:b] for a, b in spans]
        if model_col is not None:
            if first_model is None:
                first_model = toks[model_col]
            elif toks[model_col] != first_model:
                continue  # parse_cif keeps only the first model
        if k >= len(bf):
            return None
        a, b = spans[bf_col]
        new = f"{bf[k]:.2f}"
        # Keep column alignment when the new value fits the old width.
        if len(new) < b - a:
            new = new.rjust(b - a)
        lines[idx] = lines[idx][:a] + new + lines[idx][b:]
        k += 1
    if k != len(bf):
        return None
    return "\n".join(lines)
