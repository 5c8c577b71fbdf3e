"""DCD trajectory reader (CHARMM/NAMD binary format).

Minimal, numpy-vectorized reader for the workload of the reference's
mdsasa-bolt companion package (reference: README.md:98-149 - per-frame
SASA over an MD trajectory, ~20x faster than mdakit-sasa).  Handles both
endiannesses, the optional unit-cell block, and fixed-atom-free
trajectories (the common NAMD/CHARMM output shape).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


class DCDError(ValueError):
    pass


class _Truncated(DCDError):
    """Record extends past the available bytes (may just need more data)."""


@dataclass
class DCDHeader:
    n_frames: int
    n_atoms: int
    has_unit_cell: bool
    endian: str  # '<' or '>'
    header_size: int
    frame_size: int
    title: str


def _read_record(buf: memoryview, off: int, endian: str) -> tuple[memoryview, int]:
    if off + 4 > len(buf):
        raise _Truncated("truncated DCD record")
    n = int(np.frombuffer(buf[off:off + 4], dtype=f"{endian}i4")[0])
    end = off + 4 + n
    if end + 4 > len(buf):
        raise _Truncated("truncated DCD record body")
    tail = int(np.frombuffer(buf[end:end + 4], dtype=f"{endian}i4")[0])
    if tail != n:
        raise DCDError("corrupt DCD record framing")
    return buf[off + 4:end], end + 4


def read_header(data: bytes, total_size: int | None = None) -> DCDHeader:
    """Parse the header from the leading bytes of a DCD file.

    total_size: full file size in bytes when `data` is only a prefix (the
    streaming reader passes this so the available-frame count is computed
    against the file, not the prefix).
    """
    buf = memoryview(data)
    # Detect endianness from the first record marker (always 84).
    first = np.frombuffer(buf[0:4], dtype="<i4")[0]
    endian = "<" if first == 84 else ">"
    if endian == ">" and np.frombuffer(buf[0:4], dtype=">i4")[0] != 84:
        raise DCDError("not a DCD file (bad leading record length)")

    rec, off = _read_record(buf, 0, endian)
    if bytes(rec[0:4]) != b"CORD":
        raise DCDError("not a DCD file (missing CORD magic)")
    icntrl = np.frombuffer(rec[4:4 + 80], dtype=f"{endian}i4")
    n_frames = int(icntrl[0])
    has_unit_cell = bool(icntrl[10])

    title_rec, off = _read_record(buf, off, endian)
    ntitle = int(np.frombuffer(title_rec[0:4], dtype=f"{endian}i4")[0])
    title = bytes(title_rec[4:4 + 80 * ntitle]).decode("ascii", "replace")

    natoms_rec, off = _read_record(buf, off, endian)
    n_atoms = int(np.frombuffer(natoms_rec[0:4], dtype=f"{endian}i4")[0])

    cell_bytes = (8 + 48) if has_unit_cell else 0
    frame_size = cell_bytes + 3 * (8 + 4 * n_atoms)
    size = len(data) if total_size is None else total_size
    avail = (size - off) // frame_size if frame_size else 0
    if n_frames <= 0 or n_frames > avail:
        n_frames = avail
    return DCDHeader(
        n_frames=n_frames,
        n_atoms=n_atoms,
        has_unit_cell=has_unit_cell,
        endian=endian,
        header_size=off,
        frame_size=frame_size,
        title=title.strip(),
    )


def _read_header_stream(f, file_size: int) -> DCDHeader:
    """Parse the header by reading a growing prefix (never the whole file)."""
    chunk = f.read(min(65536, file_size))
    while True:
        try:
            return read_header(chunk, total_size=file_size)
        except _Truncated:
            if len(chunk) >= file_size:
                raise
            more = f.read(min(len(chunk), file_size - len(chunk)))
            if not more:
                raise
            chunk += more


def read_dcd(path: str) -> tuple[DCDHeader, np.ndarray]:
    """Read a DCD file -> (header, coords [n_frames, n_atoms, 3] float32).

    Decodes block-by-block via iter_frame_blocks, so peak memory is the
    output array plus one block of raw bytes (not the whole file twice).
    """
    h = None
    out = None
    for hdr, fr, coords in iter_frame_blocks(path):
        if out is None:
            h = hdr
            out = np.empty((hdr.n_frames, hdr.n_atoms, 3), dtype=np.float32)
        out[fr:fr + coords.shape[0]] = coords
    if out is None:  # zero frames: still return a parsed header
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            h = _read_header_stream(f, size)
        out = np.empty((0, h.n_atoms, 3), dtype=np.float32)
    return h, out


def write_dcd(path: str, coords: np.ndarray, has_unit_cell: bool = False) -> None:
    """Write a minimal little-endian DCD (for tests and interchange)."""
    f_count, n_atoms, _ = coords.shape

    def rec(payload: bytes) -> bytes:
        n = np.int32(len(payload)).tobytes()
        return n + payload + n

    icntrl = np.zeros(20, dtype="<i4")
    icntrl[0] = f_count
    icntrl[1] = 1
    icntrl[2] = 1
    icntrl[10] = 1 if has_unit_cell else 0
    icntrl[19] = 24  # CHARMM version stamp
    header = b"CORD" + icntrl.tobytes()
    title = np.int32(1).tobytes() + b"rustsasa_tpu trajectory".ljust(80)
    natoms = np.int32(n_atoms).tobytes()
    with open(path, "wb") as f:
        f.write(rec(header))
        f.write(rec(title))
        f.write(rec(natoms))
        cell = np.zeros(6, dtype="<f8")
        for fr in range(f_count):
            if has_unit_cell:
                f.write(rec(cell.tobytes()))
            for d in range(3):
                f.write(rec(coords[fr, :, d].astype("<f4").tobytes()))


def iter_frame_blocks(path: str, block: int = 16):
    """Yield (header, frame_start, coords [b, n_atoms, 3]) blocks lazily.

    Streams via seeked block reads: resident memory is one block of raw
    frames (block * frame_size bytes) plus the decoded array - a multi-GB
    trajectory never gets slurped whole.  (Round-3 review: the old
    implementation read the entire file upfront while claiming to stream.)
    """
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        h = _read_header_stream(f, size)
        f.seek(h.header_size)
        fdt = f"{h.endian}f4"
        fr = 0
        while fr < h.n_frames:
            b = min(block, h.n_frames - fr)
            data = f.read(b * h.frame_size)
            buf = memoryview(data)
            off = 0
            out = np.empty((b, h.n_atoms, 3), dtype=np.float32)
            for i in range(b):
                if h.has_unit_cell:
                    _, off = _read_record(buf, off, h.endian)
                for d in range(3):
                    rec, off = _read_record(buf, off, h.endian)
                    out[i, :, d] = np.frombuffer(rec, dtype=fdt, count=h.n_atoms)
            yield h, fr, out
            fr += b
