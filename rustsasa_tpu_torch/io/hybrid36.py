"""Hybrid-36 numbering for PDB fixed columns.

The PDB format caps atom serials at 99999 (5 columns) and residue
numbers at 9999 (4 columns).  Hybrid-36 (Grosse-Kunstleve, used by
cctbx/Phenix and understood by most modern tools) extends both ranges by
switching to base-36: serials 100000.. encode as A0000..ZZZZZ then
a0000..zzzzz.  The reference delegates this to pdbtbx's writer
(src/utils/io.rs:20-64 + pdbtbx::save); here it keeps >99999-atom
structures round-trippable through our own PDB writer.
"""

from __future__ import annotations

_DIGITS_UPPER = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def encode(value: int, width: int) -> str:
    """Encode `value` into `width` columns, hybrid-36 beyond 10**width."""
    if value < 10**width:
        return str(value).rjust(width)
    span = 26 * 36 ** (width - 1)
    base = 10 * 36 ** (width - 1)
    if value < 10**width + span:
        v = value - 10**width + base
        return _b36(v, width)
    if value < 10**width + 2 * span:
        v = value - 10**width - span + base
        return _b36(v, width).lower()
    raise ValueError(f"value {value} exceeds hybrid-36 width {width}")


def max_value(width: int) -> int:
    """Largest value encodable in `width` hybrid-36 columns."""
    return 10**width + 2 * 26 * 36 ** (width - 1) - 1


def _b36(v: int, width: int) -> str:
    out = []
    while v:
        out.append(_DIGITS_UPPER[v % 36])
        v //= 36
    return "".join(reversed(out)).rjust(width, "0")


def decode(s: str, width: int | None = None) -> int:
    """Decode a hybrid-36 field (plain decimal passes through).

    Raises ValueError on anything that is neither decimal nor hybrid-36.
    """
    s = s.strip()
    if not s:
        raise ValueError("empty hybrid-36 field")
    if width is None:
        width = len(s)
    first = s[0]
    if first.isdigit() or first in "+-":
        return int(s)
    v = int(s, 36)  # case-insensitive
    base = 10 * 36 ** (width - 1)
    if first.isupper():
        return v - base + 10**width
    return v - base + 10**width + 26 * 36 ** (width - 1)
