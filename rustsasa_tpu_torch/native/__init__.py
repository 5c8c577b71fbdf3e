"""Native (C++) fast ingest, loaded via ctypes.

The shared library is built from this package's own `fastparse.cpp` on
first use, with g++, under an exclusive lock (`_host_build`), into
`build/rustsasa_tpu_torch/libfastparse_<key>.so` beside the package; the
key hashes the source and the compiler flags.  Where `build/` cannot be
written (a read-only install) it goes to ~/.cache/rustsasa_tpu_torch.
The library's radius table is process-global, and it is this package's
own: no other package loads this file.  All entry points release the
GIL, so a Python thread pool of parser workers scales across host cores.
Falls back cleanly (returns None from load_library) when no toolchain is
available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from .._host_build import build_shared_library

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastparse.cpp")
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
_LIBS = ("-lz",)


def _lib_name() -> str:
    h = hashlib.sha256(" ".join(_FLAGS + _LIBS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return f"libfastparse_{h.hexdigest()[:16]}.so"


_LIB = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                    "rustsasa_tpu_torch", _lib_name())
# Read-only installs (e.g. system site-packages) build into the user
# cache instead.
_LIB_FALLBACK = os.path.join(
    os.path.expanduser("~"), ".cache", "rustsasa_tpu_torch",
    os.path.basename(_LIB)
)

_lock = threading.Lock()
_lib = None
_lib_failed = False


class _FPResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("coords", ctypes.POINTER(ctypes.c_float)),
        ("serial", ctypes.POINTER(ctypes.c_int64)),
        ("res_serial", ctypes.POINTER(ctypes.c_int64)),
        ("occupancy", ctypes.POINTER(ctypes.c_float)),
        ("bfactor", ctypes.POINTER(ctypes.c_float)),
        ("hetero", ctypes.POINTER(ctypes.c_uint8)),
        ("chain_code", ctypes.POINTER(ctypes.c_int32)),
        ("resname_code", ctypes.POINTER(ctypes.c_int32)),
        ("name_code", ctypes.POINTER(ctypes.c_int32)),
        ("alt_code", ctypes.POINTER(ctypes.c_int32)),
        ("icode_code", ctypes.POINTER(ctypes.c_int32)),
        ("element_code", ctypes.POINTER(ctypes.c_int32)),
        ("chain_tab", ctypes.POINTER(ctypes.c_char)),
        ("n_chain", ctypes.c_int32),
        ("resname_tab", ctypes.POINTER(ctypes.c_char)),
        ("n_resname", ctypes.c_int32),
        ("name_tab", ctypes.POINTER(ctypes.c_char)),
        ("n_name", ctypes.c_int32),
        ("alt_tab", ctypes.POINTER(ctypes.c_char)),
        ("n_alt", ctypes.c_int32),
        ("icode_tab", ctypes.POINTER(ctypes.c_char)),
        ("n_icode", ctypes.c_int32),
        ("element_tab", ctypes.POINTER(ctypes.c_char)),
        ("n_element", ctypes.c_int32),
        ("is_cif", ctypes.c_int32),
        ("error", ctypes.c_char * 256),
        ("owner", ctypes.c_void_p),
    ]


def _build(out: str) -> bool:
    cmd = ["g++", *_FLAGS, _SRC, "-o", out, *_LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def _locate_or_build() -> str | None:
    """Return the path of a complete, loadable libfastparse, building it
    under the lock if needed; None when it cannot be built."""
    for lib in (_LIB, _LIB_FALLBACK):
        try:
            os.makedirs(os.path.dirname(lib), exist_ok=True)
            return build_shared_library(_SRC, lib, _build)
        except OSError:
            continue
    return None


def load_library():
    """Load (building if needed) the native parser; None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        lib_path = _locate_or_build()
        if lib_path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            _lib_failed = True
            return None
        lib.fastparse_file.argtypes = [ctypes.c_char_p]
        lib.fastparse_file.restype = ctypes.POINTER(_FPResult)
        if hasattr(lib, "fastparse_file_lean"):
            lib.fastparse_file_lean.argtypes = [ctypes.c_char_p]
            lib.fastparse_file_lean.restype = ctypes.POINTER(_FPResult)
        lib.fastparse_free.argtypes = [ctypes.POINTER(_FPResult)]
        lib.fastparse_free.restype = None
        _lib = lib
        return _lib


def _codes_to_str(codes_ptr, n, tab_ptr, n_tab, width=8):
    codes = np.ctypeslib.as_array(codes_ptr, shape=(n,))
    raw = ctypes.string_at(tab_ptr, n_tab * width) if n_tab else b""
    table = np.frombuffer(raw, dtype=f"S{width}").astype(f"U{width}")
    if n_tab == 0:
        return np.full(n, "", dtype=f"U{width}"), codes.copy()
    return table[codes], codes.copy()


def parse_file_native(path: str):
    """Parse a structure file natively -> (AtomTable, format) or None.

    Returns None when the native library is unavailable; raises
    StructureReadError-compatible ValueError on parse failure.
    """
    lib = load_library()
    if lib is None:
        return None
    from ..io.structure import AtomTable

    res = lib.fastparse_file(path.encode())
    try:
        r = res.contents
        if r.error and r.error != b"":
            raise ValueError(r.error.decode(errors="replace"))
        n = int(r.n)
        if n == 0:
            return AtomTable.empty(), ("cif" if r.is_cif else "pdb")
        coords = np.ctypeslib.as_array(r.coords, shape=(n, 3)).copy()
        name, name_c = _codes_to_str(r.name_code, n, r.name_tab, r.n_name)
        alt, alt_c = _codes_to_str(r.alt_code, n, r.alt_tab, r.n_alt)
        resname, resname_c = _codes_to_str(r.resname_code, n, r.resname_tab, r.n_resname)
        chain, chain_c = _codes_to_str(r.chain_code, n, r.chain_tab, r.n_chain)
        icode, icode_c = _codes_to_str(r.icode_code, n, r.icode_tab, r.n_icode)
        element, _ = _codes_to_str(r.element_code, n, r.element_tab, r.n_element)
        table = AtomTable(
            coords=coords,
            serial=np.ctypeslib.as_array(r.serial, shape=(n,)).copy(),
            name=name,
            alt_loc=alt,
            resname=resname,
            chain_id=chain,
            res_serial=np.ctypeslib.as_array(r.res_serial, shape=(n,)).copy(),
            icode=icode,
            occupancy=np.ctypeslib.as_array(r.occupancy, shape=(n,)).copy(),
            bfactor=np.ctypeslib.as_array(r.bfactor, shape=(n,)).copy(),
            element=element,
            hetero=np.ctypeslib.as_array(r.hetero, shape=(n,)).copy().astype(bool),
            chain_code=chain_c,
            resname_code=resname_c,
            name_code=name_c,
            alt_code=alt_c,
            icode_code=icode_c,
        )
        return table, ("cif" if r.is_cif else "pdb")
    finally:
        lib.fastparse_free(res)


# ---------------------------------------------------------------------------
# fastpipe: native parse+select+emit pipeline (see fastparse.cpp, fastpipe
# section).  Python-side wrappers translate C error sentinels back into the
# package's exception types so callers see identical semantics to the
# numpy path (levels.build_selection / io.serialize).
# ---------------------------------------------------------------------------


class _SelResult(ctypes.Structure):
    _fields_ = [
        ("m", ctypes.c_int64),
        ("coords", ctypes.POINTER(ctypes.c_float)),
        ("radii", ctypes.POINTER(ctypes.c_float)),
        ("gids", ctypes.POINTER(ctypes.c_int32)),
        ("residue_slot", ctypes.POINTER(ctypes.c_int32)),
        ("n_res", ctypes.c_int64),
        ("res_serial", ctypes.POINTER(ctypes.c_int64)),
        ("res_icode_code", ctypes.POINTER(ctypes.c_int32)),
        ("res_name_code", ctypes.POINTER(ctypes.c_int32)),
        ("res_chain_idx", ctypes.POINTER(ctypes.c_int32)),
        ("n_chain", ctypes.c_int32),
        ("error", ctypes.c_char * 320),
        ("owner", ctypes.c_void_p),
    ]


_pipe_ready = False
_pipe_lock = threading.Lock()


def _setup_pipe(lib) -> None:
    lib.fastpipe_set_radii.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.fastpipe_set_radii.restype = None
    lib.fastpipe_select.argtypes = [
        ctypes.POINTER(_FPResult), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.fastpipe_select.restype = ctypes.POINTER(_SelResult)
    lib.fastpipe_sel_free.argtypes = [ctypes.POINTER(_SelResult)]
    lib.fastpipe_sel_free.restype = None
    lib.fastpipe_emit.argtypes = [
        ctypes.POINTER(_FPResult), ctypes.POINTER(_SelResult),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.fastpipe_emit.restype = ctypes.c_int
    lib.fastpipe_emit_counts.argtypes = [
        ctypes.POINTER(_FPResult), ctypes.POINTER(_SelResult),
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_char_p,
    ]
    lib.fastpipe_emit_counts.restype = ctypes.c_int

    _push_radii_table(lib, None)
    global _radii_loaded_key
    _radii_loaded_key = None


# Content key of the radii table currently loaded into the native lib:
# None = embedded ProtOr.  Guarded by _pipe_lock.
_radii_loaded_key: object = "unset"


def _push_radii_table(lib, radii_config) -> None:
    from ..radii import PROTOR_RADII, VDW_RADII

    # The reference consults the custom config first and falls back to
    # ProtOr per (residue, atom) pair (utils.rs:40-56); a per-residue
    # dict overlay reproduces that precedence exactly.
    table: dict = PROTOR_RADII
    if radii_config:
        table = {res: dict(inner) for res, inner in PROTOR_RADII.items()}
        for res, inner in radii_config.items():
            table.setdefault(res, {}).update(inner)
    pair_lines = []
    for res, inner in table.items():
        for atom, rad in inner.items():
            pair_lines.append(f"{res}\t{atom}\t{rad!r}")
    vdw_lines = [f"{el}\t{rad!r}" for el, rad in VDW_RADII.items()]
    lib.fastpipe_set_radii(
        ("\n".join(pair_lines) + "\n").encode(),
        ("\n".join(vdw_lines) + "\n").encode(),
    )


def set_pipe_radii(radii_config) -> None:
    """Load `radii_config` (a RadiiConfig dict, or None for the embedded
    ProtOr table) into the native pipeline's radius map.

    The map is process-global native state: call before starting worker
    threads (process_directory does), not concurrently with selections.
    Cheap no-op when the requested table is already loaded.
    """
    global _radii_loaded_key
    lib = pipe_library()
    if lib is None:
        return
    # The normalized tuple itself is the key (a hash() key could
    # collide and silently keep the wrong table loaded).
    key = (
        None
        if not radii_config
        else tuple(
            (res, tuple(sorted(inner.items())))
            for res, inner in sorted(radii_config.items())
        )
    )
    with _pipe_lock:
        if key == _radii_loaded_key:
            return
        _push_radii_table(lib, radii_config)
        _radii_loaded_key = key


def pipe_library():
    """The native library with the fastpipe entry points set up, or None."""
    global _pipe_ready
    lib = load_library()
    if lib is None:
        return None
    if not _pipe_ready:
        with _pipe_lock:
            if not _pipe_ready:
                if not hasattr(lib, "fastpipe_select"):
                    return None
                _setup_pipe(lib)
                _pipe_ready = True
    return lib


_LEVEL_CODE = {"atom": 0, "residue": 1, "chain": 2, "protein": 3}
_FMT_CODE = {"json": 0, "xml": 1}

_pack_ready = False
_pack_lock = threading.Lock()


def _setup_pack(lib) -> None:
    FloatP = ctypes.POINTER(ctypes.c_float)
    IntP = ctypes.POINTER(ctypes.c_int32)
    lib.fastpack.argtypes = [
        ctypes.c_int32,                    # n_structs
        ctypes.POINTER(FloatP),            # coords
        ctypes.POINTER(FloatP),            # radii
        ctypes.POINTER(IntP),              # gids
        IntP,                              # ns
        ctypes.c_float,                    # probe
        ctypes.c_int64,                    # m_total
        FloatP,                            # planes5 out
        ctypes.POINTER(ctypes.c_uint32),   # jlist out
        IntP,                              # inv out
        ctypes.POINTER(ctypes.c_int64),    # pos out
    ]
    lib.fastpack.restype = ctypes.c_int32
    if hasattr(lib, "fastpack_q16"):
        U16P = ctypes.POINTER(ctypes.c_uint16)
        lib.fastpack_q16.argtypes = [
            ctypes.c_int32,                    # n_structs
            ctypes.POINTER(FloatP),            # coords
            ctypes.POINTER(FloatP),            # radii
            IntP,                              # ns
            ctypes.c_float,                    # probe
            ctypes.c_int64,                    # m_total
            U16P,                              # planes4 out
            FloatP,                            # tparams out
            IntP,                              # tmeta out
            IntP,                              # inv out
            ctypes.POINTER(ctypes.c_int64),    # pos out
            ctypes.c_int32,                    # n_threads
        ]
        lib.fastpack_q16.restype = ctypes.c_int32
    if hasattr(lib, "fastpack_q13"):
        U16P = ctypes.POINTER(ctypes.c_uint16)
        lib.fastpack_q13.argtypes = [
            ctypes.c_int32,                    # n_structs
            ctypes.POINTER(FloatP),            # coords
            ctypes.POINTER(FloatP),            # radii
            IntP,                              # ns
            ctypes.c_float,                    # probe
            ctypes.c_int64,                    # m_total
            ctypes.POINTER(ctypes.c_uint32),   # wire_a out
            U16P,                              # wire_b out
            FloatP,                            # palette out
            FloatP,                            # tparams out
            IntP,                              # tmeta out
            IntP,                              # inv out
            ctypes.POINTER(ctypes.c_int64),    # pos out
            ctypes.c_int32,                    # n_threads
        ]
        lib.fastpack_q13.restype = ctypes.c_int32


def _pack_pointers(structures):
    """Marshal (coords, radii) arrays into C pointer tables.

    Returns (coords_p, radii_p, keepalive) - keepalive holds the numpy
    arrays so their buffers outlive the native call.
    """
    FloatP = ctypes.POINTER(ctypes.c_float)
    n_structs = len(structures)
    coords_arrs = [
        np.ascontiguousarray(s[0], dtype=np.float32) for s in structures
    ]
    radii_arrs = [
        np.ascontiguousarray(s[1], dtype=np.float32) for s in structures
    ]
    coords_p = (FloatP * n_structs)(
        *[a.ctypes.data_as(FloatP) for a in coords_arrs]
    )
    radii_p = (FloatP * n_structs)(
        *[a.ctypes.data_as(FloatP) for a in radii_arrs]
    )
    return coords_p, radii_p, (coords_arrs, radii_arrs)


def fastpack_q16(structures, probe: float, n_threads: int | None = None):
    """Native packing for the banded device-cull path, or None.

    Same contract as ops.fused_kernel._pack_structures_q16_numpy:
    (planes4 [4, M] u16, tparams [T, 4] f32, tmeta [T, 2] i32, offsets)
    with offsets[i] = (slot, n, inv); None when the library is missing
    OR any structure is unquantizable (caller falls back).
    """
    global _pack_ready
    lib = load_library()
    if lib is None:
        return None
    if not _pack_ready:
        with _pack_lock:
            if not _pack_ready:
                if not hasattr(lib, "fastpack"):
                    return None
                _setup_pack(lib)
                _pack_ready = True
    if not hasattr(lib, "fastpack_q16"):
        return None

    n_structs = len(structures)
    ns = np.array([s[0].shape[0] for s in structures], dtype=np.int32)
    tiles = (ns + 127) // 128
    total_tiles = int(tiles.sum())
    if total_tiles > 65535:
        raise ValueError(
            f"chunk too large for u16 tile ids: {total_tiles} tiles"
        )
    m = total_tiles * 128
    planes4 = np.zeros((4, m), dtype=np.uint16)
    tparams = np.empty((total_tiles, 4), dtype=np.float32)
    tmeta = np.empty((total_tiles, 2), dtype=np.int32)
    inv = np.empty(int(ns.sum()), dtype=np.int32)
    pos = np.empty(n_structs, dtype=np.int64)

    IntP = ctypes.POINTER(ctypes.c_int32)
    coords_p, radii_p, _keep = _pack_pointers(structures)
    if n_threads is None:
        n_threads = min(4, os.cpu_count() or 1)
    rc = lib.fastpack_q16(
        n_structs, coords_p, radii_p,
        ns.ctypes.data_as(IntP), ctypes.c_float(probe), m,
        planes4.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        tparams.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tmeta.ctypes.data_as(IntP),
        inv.ctypes.data_as(IntP),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(n_threads),
    )
    if rc != 0:
        return None
    offsets = []
    inv_off = 0
    for s in range(n_structs):
        n = int(ns[s])
        offsets.append((int(pos[s]), n, inv[inv_off:inv_off + n]))
        inv_off += n
    return planes4, tparams, tmeta, offsets


def fastpack_q13(structures, probe: float, n_threads: int | None = None):
    """Native packing for the 6 B/slot q13 wire.

    Same contract as ops.fused_kernel._pack_structures_q13_numpy:
    (wire_a [M] u32, wire_b [M] u16, palette [256] f32, tparams, tmeta,
    offsets).  Returns None when the library is missing (caller runs the
    numpy spec) and the string "ineligible" when the chunk can't take
    the q13 wire (extent/palette limits; caller falls back to q16).
    """
    global _pack_ready
    lib = load_library()
    if lib is None:
        return None
    if not _pack_ready:
        with _pack_lock:
            if not _pack_ready:
                if not hasattr(lib, "fastpack"):
                    return None
                _setup_pack(lib)
                _pack_ready = True
    if not hasattr(lib, "fastpack_q13"):
        return None

    n_structs = len(structures)
    ns = np.array([s[0].shape[0] for s in structures], dtype=np.int32)
    tiles = (ns + 127) // 128
    total_tiles = int(tiles.sum())
    if total_tiles > 65535:
        raise ValueError(
            f"chunk too large for u16 tile ids: {total_tiles} tiles"
        )
    m = total_tiles * 128
    wire_a = np.zeros(m, dtype=np.uint32)
    wire_b = np.zeros(m, dtype=np.uint16)
    palette = np.zeros(256, dtype=np.float32)
    tparams = np.empty((total_tiles, 4), dtype=np.float32)
    tmeta = np.empty((total_tiles, 2), dtype=np.int32)
    inv = np.empty(int(ns.sum()), dtype=np.int32)
    pos = np.empty(n_structs, dtype=np.int64)

    IntP = ctypes.POINTER(ctypes.c_int32)
    coords_p, radii_p, _keep = _pack_pointers(structures)
    if n_threads is None:
        n_threads = min(4, os.cpu_count() or 1)
    rc = lib.fastpack_q13(
        n_structs, coords_p, radii_p,
        ns.ctypes.data_as(IntP), ctypes.c_float(probe), m,
        wire_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        wire_b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        palette.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tparams.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tmeta.ctypes.data_as(IntP),
        inv.ctypes.data_as(IntP),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(n_threads),
    )
    if rc != 0:
        return "ineligible"
    offsets = []
    inv_off = 0
    for s in range(n_structs):
        n = int(ns[s])
        offsets.append((int(pos[s]), n, inv[inv_off:inv_off + n]))
        inv_off += n
    return wire_a, wire_b, palette, tparams, tmeta, offsets


def fastpack(structures, probe: float):
    """Native chunk packing for the fused kernel, or None if unavailable.

    Same contract as ops.fused_kernel.pack_structures: returns
    (planes [5, M] f32, jlist [T, 128] u32 (mask<<16)|id, offsets,
    failed) where
    offsets[i] = (slot, n, inv) or None for failed (overflowed) inputs.
    """
    global _pack_ready
    lib = load_library()
    if lib is None:
        return None
    if not _pack_ready:
        with _pack_lock:
            if not _pack_ready:
                if not hasattr(lib, "fastpack"):
                    return None
                _setup_pack(lib)
                _pack_ready = True

    n_structs = len(structures)
    ns = np.array([s[0].shape[0] for s in structures], dtype=np.int32)
    tiles = (ns + 127) // 128
    total_tiles = int(tiles.sum())
    if total_tiles > 65535:
        raise ValueError(
            f"chunk too large for u16 tile ids: {total_tiles} tiles"
        )
    m = total_tiles * 128
    planes = np.zeros((5, m), dtype=np.float32)
    jlist = np.zeros((total_tiles, 128), dtype=np.uint32)
    inv = np.empty(int(ns.sum()), dtype=np.int32)
    pos = np.empty(n_structs, dtype=np.int64)

    FloatP = ctypes.POINTER(ctypes.c_float)
    IntP = ctypes.POINTER(ctypes.c_int32)
    coords_arrs = [
        np.ascontiguousarray(s[0], dtype=np.float32) for s in structures
    ]
    radii_arrs = [
        np.ascontiguousarray(s[1], dtype=np.float32) for s in structures
    ]
    gids_arrs = [
        np.ascontiguousarray(s[2], dtype=np.int32) for s in structures
    ]
    coords_p = (FloatP * n_structs)(
        *[a.ctypes.data_as(FloatP) for a in coords_arrs]
    )
    radii_p = (FloatP * n_structs)(
        *[a.ctypes.data_as(FloatP) for a in radii_arrs]
    )
    gids_p = (IntP * n_structs)(
        *[a.ctypes.data_as(IntP) for a in gids_arrs]
    )

    lib.fastpack(
        n_structs, coords_p, radii_p, gids_p,
        ns.ctypes.data_as(IntP), ctypes.c_float(probe), m,
        planes.ctypes.data_as(FloatP),
        jlist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        inv.ctypes.data_as(IntP),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )

    offsets = []
    failed: list[int] = []
    inv_off = 0
    for s in range(n_structs):
        n = int(ns[s])
        if pos[s] < 0:
            offsets.append(None)
            failed.append(s)
        else:
            offsets.append((int(pos[s]), n, inv[inv_off:inv_off + n]))
        inv_off += n
    return planes, jlist, offsets, failed


class NativeFallback(Exception):
    """Native path declined this input; use the Python path."""


_PyMemoryView_FromMemory = ctypes.pythonapi.PyMemoryView_FromMemory
_PyMemoryView_FromMemory.restype = ctypes.py_object
_PyMemoryView_FromMemory.argtypes = [
    ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_int,
]
_PyBUF_WRITE = 0x200


def _view(addr: int, count: int, dtype) -> np.ndarray:
    """Zero-copy numpy view over native memory (lifetime owned by the
    caller's handle, exactly like the previous ctypeslib views)."""
    nbytes = count * np.dtype(dtype).itemsize
    mv = _PyMemoryView_FromMemory(addr, nbytes, _PyBUF_WRITE)
    return np.frombuffer(mv, dtype=dtype)


class NativeSelection:
    """A parsed + selected structure living in native memory.

    Exposes zero-copy numpy views (coords/radii/gids) for the device
    engine; `emit` aggregates and writes the result file natively.
    """

    __slots__ = ("_lib", "_fp", "_sel", "coords", "radii", "gids", "path")

    def __init__(self, lib, fp, sel, path):
        self._lib = lib
        self._fp = fp
        self._sel = sel
        self.path = path
        m = int(sel.contents.m)
        if m:
            # PyMemoryView_FromMemory + frombuffer: ~1.5 us per view vs
            # ~27 us for np.ctypeslib.as_array (which builds a fresh
            # ctypes array TYPE per distinct shape) - x3 views per file
            # this was a measured ~80 us/file of pipeline host time.
            self.coords = _view(
                ctypes.addressof(sel.contents.coords.contents), m * 3,
                np.float32,
            ).reshape(m, 3)
            self.radii = _view(
                ctypes.addressof(sel.contents.radii.contents), m, np.float32
            )
            self.gids = _view(
                ctypes.addressof(sel.contents.gids.contents), m, np.int32
            )
        else:
            self.coords = np.zeros((0, 3), np.float32)
            self.radii = np.zeros(0, np.float32)
            self.gids = np.zeros(0, np.int32)

    def emit(self, atom_sasa: np.ndarray, level: str, fmt: str,
             out_path: str) -> None:
        sasa = np.ascontiguousarray(atom_sasa, dtype=np.float32)
        err = ctypes.create_string_buffer(256)
        rc = self._lib.fastpipe_emit(
            self._fp, self._sel,
            sasa.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _LEVEL_CODE[level], _FMT_CODE[fmt], out_path.encode(), err)
        if rc != 0:
            raise OSError(err.value.decode(errors="replace"))

    def emit_counts(self, counts: np.ndarray, inv: np.ndarray,
                    area_const: float, probe: float, level: str, fmt: str,
                    out_path: str) -> float:
        """Fused unpack + aggregate + serialize + write from raw device
        occlusion counts (packed Morton-slot order) - bit-identical
        output to emit() fed the numpy-reconstructed SASA.  Returns the
        total area (f64 sum)."""
        counts = np.ascontiguousarray(counts)
        wide = 1 if counts.dtype == np.uint16 else 0
        if counts.dtype not in (np.uint8, np.uint16):
            raise ValueError(f"counts dtype {counts.dtype} unsupported")
        inv = np.ascontiguousarray(inv)
        if inv.dtype == np.int64:
            inv64 = 1
        elif inv.dtype == np.int32:
            inv64 = 0
        else:
            inv = np.ascontiguousarray(inv, dtype=np.int64)
            inv64 = 1
        err = ctypes.create_string_buffer(256)
        total = ctypes.c_double(0.0)
        rc = self._lib.fastpipe_emit_counts(
            self._fp, self._sel,
            counts.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(counts.shape[0]), wide,
            inv.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(inv.shape[0]), inv64,
            ctypes.c_float(area_const), ctypes.c_float(probe),
            _LEVEL_CODE[level], _FMT_CODE[fmt], out_path.encode(),
            ctypes.byref(total), err)
        if rc != 0:
            raise OSError(err.value.decode(errors="replace"))
        return float(total.value)

    def close(self) -> None:
        if self._sel is not None:
            self._lib.fastpipe_sel_free(self._sel)
            self._sel = None
        if self._fp is not None:
            self._lib.fastparse_free(self._fp)
            self._fp = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


def _raise_select_error(tag: bytes, path: str):
    from ..io.read import StructureReadError
    from ..levels import ElementMissingError
    from ..radii import RadiusMissingError, VanDerWaalsMissingError

    parts = tag.decode(errors="replace").split("\t")
    kind = parts[0]
    if kind == "E_FALLBACK":
        raise NativeFallback()
    if kind == "E_ELEMENT":
        raise ElementMissingError(
            f"Element missing for atom {parts[1]} (serial {parts[2]})")
    if kind == "E_RADIUS":
        raise RadiusMissingError(parts[1], parts[2], parts[3])
    if kind == "E_VDW":
        raise VanDerWaalsMissingError(parts[1])
    if kind == "E_NONFINITE":
        raise ValueError(
            "structure contains non-finite coordinates or radii"
        )
    raise StructureReadError(f"Failed to read from input file: {kind}")


def native_process_file(
    path: str, *, level: str, include_hydrogens: bool,
    include_hetatms: bool, read_radii_from_occupancy: bool,
    allow_vdw_fallback: bool,
) -> NativeSelection:
    """Parse + select a structure file entirely in native code.

    Raises NativeFallback when the native path can't handle the input
    (caller falls back to the Python pipeline) and the package's standard
    typed errors for real failures.
    """
    from ..io.read import StructureReadError

    lib = pipe_library()
    if lib is None:
        raise NativeFallback()
    # Lean parse skips occupancy/b-factor float parsing (two of five
    # float fields): this pipeline only emits json/xml, so those columns
    # are read downstream only via the occupancy-radii flag.
    if not read_radii_from_occupancy and hasattr(lib, "fastparse_file_lean"):
        fp = lib.fastparse_file_lean(path.encode())
    else:
        fp = lib.fastparse_file(path.encode())
    try:
        if fp.contents.error and fp.contents.error != b"":
            msg = fp.contents.error.decode(errors="replace")
            raise StructureReadError(f"Failed to read from input file: {msg}")
        if int(fp.contents.n) == 0:
            raise StructureReadError(
                f"Failed to parse {path}: no atom records found")
        sel = lib.fastpipe_select(
            fp, _LEVEL_CODE[level], int(include_hydrogens),
            int(include_hetatms), int(read_radii_from_occupancy),
            int(allow_vdw_fallback))
        try:
            if sel.contents.error and sel.contents.error != b"":
                _raise_select_error(sel.contents.error, path)
        except BaseException:
            lib.fastpipe_sel_free(sel)
            raise
        return NativeSelection(lib, fp, sel, path)
    except BaseException:
        lib.fastparse_free(fp)
        raise
