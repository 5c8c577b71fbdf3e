"""Shrake-Rupley SASA engine on PyTorch: the fused banded-wire path.

Port of `rustsasa_tpu/ops/engine.py` for the production path of the
directory batch: structures are packed on the host into the q13 wire
(the q16 wire above 100 A extent), copied to the device, dequantized,
culled into j-lists and counted by the hand-written occlusion kernel
(`fused_kernel.py`); u8/u16 counts come back and `CountsView` turns them
into per-atom SASA, or hands them to the native emit as they are.

`rustsasa_tpu/api.py` and `rustsasa_tpu/batch.py` run unchanged on this
module (see `_host.py`), through the names they import from it:
`calculate_sasa_internal`, `BatchedSasaEngine`, `CountsView`,
`SasaParams`, `CHUNK_SLOT_BUDGET`.

Not in this port yet, and raised as `UnsupportedInSlice` instead of being
routed elsewhere: the host-cull q16 and f32 wires (structures over 127
tiles, non-unique group ids, extents over 1300 A) and the neighbor-list
path (more than 2048 sphere points).

The device is explicit: "cuda" by default, the CPU only when asked for
(the CPU runs the kernels' plain-torch versions).
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .._host.constants import DEFAULT_N_POINTS, DEFAULT_PROBE_RADIUS
from .._host.ops.sphere import padded_sphere_points
from .._host.utils import stagestats
from . import fused_kernel

# Atom slots per chunk (reference engine._FUSED_ATOM_BUDGET); the batch
# pipeline streams dispatches at exactly this granularity.
CHUNK_SLOT_BUDGET = 2_097_152


class UnsupportedInSlice(NotImplementedError):
    """The input needs a path the PyTorch port does not have yet."""


_HOST_CULL_ITEM = "ROADMAP section 1, item 3 (host-cull q16/f32 wires): "
_LIST_PATH_ITEM = "ROADMAP section 1, item 4 (neighbor-list path): "


@dataclass(frozen=True)
class SasaParams:
    """Runtime parameters of one SASA evaluation."""

    probe_radius: float = DEFAULT_PROBE_RADIUS
    n_points: int = DEFAULT_N_POINTS


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _sphere_packed(n_points: int) -> np.ndarray:
    """[P_pad, 4] f32 sphere (x, y, z, point_valid), P_pad = n_points
    rounded up to 8: the layout the count kernel reads."""
    p_pad = _round_up(n_points, 8)
    sphere, point_valid = padded_sphere_points(n_points, p_pad)
    packed = np.empty((p_pad, 4), dtype=np.float32)
    packed[:, 0:3] = sphere
    packed[:, 3] = point_valid.astype(np.float32)
    return packed


@functools.lru_cache(maxsize=16)
def _sphere_device(n_points: int, device: torch.device) -> torch.Tensor:
    """Per-(n_points, device) sphere, copied to the device once."""
    return torch.from_numpy(_sphere_packed(n_points)).to(device)


def _dense_gids(gids: np.ndarray | None, n: int) -> np.ndarray:
    if gids is None:
        return np.arange(n, dtype=np.int32)
    gids = np.asarray(gids)
    if gids.dtype == np.int32 and (len(gids) == 0 or gids.min() >= 0):
        # Already-dense non-negative ids (the selection layer emits these);
        # only equality matters, no re-factorization needed.
        return gids
    _, inv = np.unique(gids, return_inverse=True)
    return inv.astype(np.int32)


def _unique_gids(gid: np.ndarray) -> bool:
    """Dense factorized gids are unique per atom iff max == n-1."""
    n = gid.shape[0]
    return n == 0 or int(gid.max()) == n - 1


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but CUDA is not available; pass "
            "device='cpu' to run the plain-torch kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_n_points(n_points: int) -> None:
    if _round_up(n_points, 8) > fused_kernel.MAX_P_PAD:
        raise UnsupportedInSlice(
            _LIST_PATH_ITEM
            + f"n_points={n_points} exceeds the count kernel's "
            f"{fused_kernel.MAX_P_PAD}-point sphere"
        )


class _Readback:
    """One chunk's counts on their way to the host.

    On CUDA the device-to-host copy is queued right behind the chunk's
    kernels into pinned memory, with an event after it; `numpy()` waits
    on that event only, not on chunks queued later.
    """

    def __init__(self, counts: torch.Tensor):
        if counts.device.type == "cuda":
            self._host = torch.empty(
                counts.shape, dtype=counts.dtype, pin_memory=True
            )
            self._host.copy_(counts, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(counts.device))
        else:
            self._host = counts
            self._event = None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        return out.view(np.uint16) if out.dtype == np.int16 else out


def _compute_fused(structures, *, probe: float, n_points: int,
                   device: torch.device) -> "_FusedPending":
    """Dispatch every chunk of `structures` without synchronizing.

    Chunks by the atom-slot budget, longest structure first; a chunk
    splits so that q13-eligible structures keep the 6 B/slot wire and the
    others take the q16 wire.  The reference pads each chunk to one of a
    few slot buckets because each shape is a separate TPU compile; the
    CUDA kernel takes any multiple of 128 slots, so chunks are not padded.
    """
    _check_n_points(n_points)
    sphere = _sphere_device(n_points, device)
    order = sorted(
        range(len(structures)), key=lambda i: -structures[i][0].shape[0]
    )
    pending = []  # (chunk, offsets, readback)

    def flush(chunk):
        if not chunk:
            return
        triples = []
        for i in chunk:
            coords, radii, gids = structures[i]
            triples.append(
                (coords, radii, _dense_gids(gids, coords.shape[0]))
            )
        for t in triples:
            nt = -(-t[0].shape[0] // fused_kernel.ATOM_TILE)
            if nt > fused_kernel.W_BUCKETS[-1]:
                raise UnsupportedInSlice(
                    _HOST_CULL_ITEM + f"a structure of {t[0].shape[0]} "
                    f"atoms ({nt} tiles) exceeds the banded cull's "
                    f"{fused_kernel.W_BUCKETS[-1]} tiles"
                )
            if not _unique_gids(t[2]):
                raise UnsupportedInSlice(
                    _HOST_CULL_ITEM + "group ids are not unique per atom"
                )
        max_nt = max(
            -(-t[0].shape[0] // fused_kernel.ATOM_TILE) for t in triples
        )
        # 6 B/slot q13 wire first; structures whose extent disqualifies
        # them split out onto the q16 wire, so one big structure does not
        # drag a whole chunk onto 8 B/slot.
        q13_ok = [
            k for k, t in enumerate(triples)
            if t[0].shape[0] == 0
            or float((t[0].max(axis=0) - t[0].min(axis=0)).max())
            <= fused_kernel.MAX_Q13_EXTENT
        ]
        if 0 < len(q13_ok) < len(chunk):
            okset = set(q13_ok)
            flush([chunk[k] for k in q13_ok])
            flush([chunk[k] for k in range(len(chunk)) if k not in okset])
            return
        w = next(b for b in fused_kernel.W_BUCKETS if b >= max_nt)
        with stagestats.stage("pack"):
            q13 = fused_kernel.pack_structures_q13(triples, probe)
        if q13 is not None:
            *wire, offsets = q13
            with stagestats.stage("dispatch"):
                wire = fused_kernel.to_device(wire, device)
                out = fused_kernel.fused_sasa_q13_banded(
                    *wire, sphere, n_points=n_points, w=w
                )
                pending.append((chunk, offsets, _Readback(out)))
            return
        with stagestats.stage("pack"):
            q16 = fused_kernel.pack_structures_q16(triples, probe)
        if q16 is None:
            raise UnsupportedInSlice(
                _HOST_CULL_ITEM + "a structure exceeds the q16 wire "
                f"({fused_kernel.MAX_Q_EXTENT} A extent or r_eff >= 8 A)"
            )
        *wire, offsets = q16
        with stagestats.stage("dispatch"):
            wire = fused_kernel.to_device(wire, device)
            out = fused_kernel.fused_sasa_q16_banded(
                *wire, sphere, n_points=n_points, w=w
            )
            pending.append((chunk, offsets, _Readback(out)))

    chunk: list[int] = []
    budget = 0
    for i in order:
        n_slots = _round_up(max(structures[i][0].shape[0], 1),
                            fused_kernel.ATOM_TILE)
        if chunk and budget + n_slots > CHUNK_SLOT_BUDGET:
            flush(chunk)
            chunk, budget = [], 0
        chunk.append(i)
        budget += n_slots
    flush(chunk)
    return _FusedPending(structures, pending, probe, n_points)


class CountsView:
    """Deferred unpack of one structure's result from a chunk's raw
    occlusion-counts readback.  Calling it materializes the per-atom SASA
    (numpy path); consumers with a native sink (batch.py + NativeSelection)
    instead read the raw fields and fuse the unpack into the C++ emit."""

    __slots__ = ("out_np", "pos", "n", "inv", "radii", "probe", "n_points")

    def __init__(self, out_np, pos, n, inv, radii, probe, n_points):
        self.out_np = out_np
        self.pos = pos
        self.n = n
        self.inv = inv
        self.radii = radii
        self.probe = probe
        self.n_points = n_points

    @property
    def area_const(self) -> np.float32:
        return np.float32(4.0 * np.pi / self.n_points)

    @property
    def counts(self) -> np.ndarray:
        return self.out_np[self.pos:self.pos + self.n]

    def __call__(self) -> np.ndarray:
        vals = self.counts[self.inv]
        r_eff = self.radii.astype(np.float32) + np.float32(self.probe)
        return vals.astype(np.float32) * (self.area_const * r_eff * r_eff)


class _FusedPending:
    """In-flight fused computation: all chunks dispatched, none read back.

    collect_views() is the synchronization point; until then the host is
    free to pack/parse/emit other work while the device drains its queue.
    """

    def __init__(self, structures, pending, probe, n_points):
        self.structures = structures
        self.pending = pending
        self.probe = probe
        self.n_points = n_points
        self.views: list = [None] * len(structures)

    def collect(self) -> list[np.ndarray]:
        with stagestats.stage("unpack"):
            return [v() for v in self.collect_views()]

    def collect_views(self) -> list:
        """Wait for every chunk; return one CountsView per structure."""
        for chunk, offsets, readback in self.pending:
            with stagestats.stage("device_wait"):
                out_np = readback.numpy()
            for i, (pos, n, inv) in zip(chunk, offsets):
                self.views[i] = CountsView(
                    out_np, pos, n, inv, self.structures[i][1],
                    self.probe, self.n_points,
                )
        self.pending = []
        return self.views


class _EagerPending:
    """Already-resolved handle (empty inputs)."""

    def __init__(self, results):
        self._results = results

    def collect(self):
        return self._results

    def collect_views(self):
        return self._results


class _MappedPending:
    """Maps an inner handle over the nonempty-structure subset."""

    def __init__(self, inner, nonempty, total):
        self._inner = inner
        self._nonempty = nonempty
        self._total = total

    def _scatter(self, outs):
        results: list = [
            np.zeros(0, np.float32) for _ in range(self._total)
        ]
        for i, out in zip(self._nonempty, outs):
            results[i] = out
        return results

    def collect(self):
        return self._scatter(self._inner.collect())

    def collect_views(self):
        return self._scatter(self._inner.collect_views())


def calculate_sasa_internal(
    coords: np.ndarray,
    radii: np.ndarray,
    *,
    group_ids: np.ndarray | None = None,
    probe_radius: float = DEFAULT_PROBE_RADIUS,
    n_points: int = DEFAULT_N_POINTS,
    device="cuda",
) -> np.ndarray:
    """Per-atom SASA for one structure (reference API: lib.rs:249-298).

    coords: [N, 3] positions in Angstroms.  radii: [N] atomic radii.
    group_ids: optional [N] int ids; atoms sharing an id never occlude
    each other.  When omitted every atom gets a distinct id.
    """
    dev = _device(device)
    coords = np.ascontiguousarray(coords, dtype=np.float32)
    radii = np.ascontiguousarray(radii, dtype=np.float32)
    n = coords.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    gid = _dense_gids(group_ids, n)
    return _compute_fused(
        [(coords, radii, gid)], probe=float(probe_radius),
        n_points=n_points, device=dev,
    ).collect()[0]


class BatchedSasaEngine:
    """Batched engine: many structures per device dispatch.

    Feed with (coords, radii, group_ids) triples.  `enqueue` packs and
    dispatches every chunk without synchronizing and returns a handle;
    its `collect_views()`/`collect()` are the readback.
    """

    def __init__(self, params: SasaParams | None = None, *, device="cuda"):
        self.params = params or SasaParams()
        self.device = _device(device)
        # Chunks dispatched so far (one count-kernel launch each);
        # enqueue may run on several threads at once.
        self.chunks_dispatched = 0
        self._lock = threading.Lock()

    def compute(self, structures) -> list[np.ndarray]:
        return self.enqueue(structures).collect()

    def enqueue(self, structures):
        """Dispatch all device work for `structures` WITHOUT synchronizing.

        Returns a handle with .collect() -> list[np.ndarray] and
        .collect_views() -> list of CountsView (empty structures get an
        empty array).  The host is free between enqueue and collect.
        """
        if not structures:
            return _EagerPending([])
        nonempty = [
            i for i, s in enumerate(structures) if s[0].shape[0] > 0
        ]
        inner = _compute_fused(
            [structures[i] for i in nonempty],
            probe=float(self.params.probe_radius),
            n_points=self.params.n_points,
            device=self.device,
        )
        with self._lock:
            self.chunks_dispatched += len(inner.pending)
        return _MappedPending(inner, nonempty, len(structures))
