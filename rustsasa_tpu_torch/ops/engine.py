"""Shrake-Rupley SASA engine on PyTorch: the fused wires and the list path.

Port of `rustsasa_tpu/ops/engine.py`.  Two backends, chosen per call as
the reference chooses on an accelerator (`resolve_backend`):

  * "fused" (spheres of up to 2048 points): structures are packed on the
    host into one of four wires and counted by the hand-written occlusion
    kernel (`fused_kernel.py`).  In order of preference: the banded q13
    wire (6 B/slot, culled on the device), the banded q16 wire (extents
    over 100 A), and the host-cull wires for what the band cannot take
    (more than 127 tiles, shared group ids, extents over 1300 A): q16
    with host j-lists when group ids are unique and the extent fits, f32
    planes with real group ids otherwise.  u8/u16 counts or f32 areas come
    back; `CountsView` turns counts into per-atom SASA, or hands them to
    the native emit as they are.  Structures whose host j-lists overflow
    are re-run on the list path.
  * "list" (any number of points): exact neighbor lists and the list
    occlusion kernel (`neighbors.py`).

The port's `api.py` and `batch.py`, copies of the reference's, run on
this module through the names they import from it:
`calculate_sasa_internal`, `BatchedSasaEngine`, `CountsView`,
`SasaParams`, `CHUNK_SLOT_BUDGET`.

The device is explicit: "cuda" by default, the CPU only when asked for
(the CPU runs the kernels' plain-torch versions).  An engine may hold a
list of device entries (`devices=`): chunks are dealt to them
round-robin, each CUDA entry with a stream of its own, as the reference
deals its chunks over `jax.local_devices()`.  One card named twice is
two streams on that card.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import DEFAULT_N_POINTS, DEFAULT_PROBE_RADIUS
from .sphere import padded_sphere_points
from ..utils import stagestats
from . import fused_kernel, neighbors

# Atom slots per chunk (reference engine._FUSED_ATOM_BUDGET); the batch
# pipeline streams dispatches at exactly this granularity.
CHUNK_SLOT_BUDGET = 2_097_152

BACKENDS = ("auto", "fused", "list")

# The reference's XLA scan chunk; it sizes the list path's batch cap.
_K_CHUNK = 16


@dataclass(frozen=True)
class SasaParams:
    """Runtime parameters of one SASA evaluation."""

    probe_radius: float = DEFAULT_PROBE_RADIUS
    n_points: int = DEFAULT_N_POINTS


class RouteCounts:
    """Device dispatches per route, safe to update from several threads.

    q13 / q16: banded wires; host_q16 / f32: host-cull wires (one count
    kernel launch each); list: neighbor-list batches, re-runs included.
    `entries[i]`: the count-kernel chunks dealt to device entry i.
    """

    NAMES = ("q13", "q16", "host_q16", "f32", "list")

    def __init__(self, n_entries: int = 1):
        self._lock = threading.Lock()
        self.counts = dict.fromkeys(self.NAMES, 0)
        self.entries = [0] * n_entries

    def add(self, route: str, entry: int | None = None) -> None:
        with self._lock:
            self.counts[route] += 1
            if entry is not None:
                self.entries[entry] += 1


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def resolve_backend(backend: str, n_points: int) -> str:
    """"fused" when the padded sphere fits the count kernel (2048 points),
    "list" otherwise; an explicit "fused" or "list" is kept."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    fits = _round_up(n_points, 8) <= fused_kernel.MAX_P_PAD
    if backend == "auto":
        return "fused" if fits else "list"
    if backend == "fused" and not fits:
        raise ValueError(
            f"n_points={n_points} exceeds the count kernel's "
            f"{fused_kernel.MAX_P_PAD}-point sphere; use backend='list'"
        )
    return backend


def _sphere_packed(n_points: int) -> np.ndarray:
    """[P_pad, 4] f32 sphere (x, y, z, point_valid), P_pad = n_points
    rounded up to 8: the layout both kernels read."""
    p_pad = _round_up(n_points, 8)
    sphere, point_valid = padded_sphere_points(n_points, p_pad)
    packed = np.empty((p_pad, 4), dtype=np.float32)
    packed[:, 0:3] = sphere
    packed[:, 3] = point_valid.astype(np.float32)
    return packed


@functools.lru_cache(maxsize=16)
def _sphere_device(n_points: int, device: torch.device) -> torch.Tensor:
    """Per-(n_points, device) sphere, copied to the device once and
    waited for, so that any stream may read it."""
    sphere = torch.from_numpy(_sphere_packed(n_points)).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return sphere


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
    if dev.type == "cuda" and dev.index is not None and not (
            0 <= dev.index < torch.cuda.device_count()):
        raise ValueError(f"{dev}: {torch.cuda.device_count()} CUDA "
                         "device(s) visible")
    return dev


def resolve_devices(devices) -> list[torch.device]:
    """Device entries from a device or a list of them.

    A bare "cuda" is every visible card in index order (the reference's
    default `jax.local_devices()`), "cuda:N" one card, "cpu" the plain
    versions; a list names its entries and may name one card twice.
    """
    if isinstance(devices, (str, torch.device)):
        dev = _device(devices)
        if dev.type == "cuda" and dev.index is None:
            out = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
            if not out:
                raise RuntimeError("device='cuda': no CUDA device visible")
            return out
        return [dev]
    out = [_device(d) for d in devices]
    if not out:
        raise ValueError("empty device list")
    return out


class DeviceRing:
    """Device entries dealt chunks round-robin, each CUDA entry of a list
    of several with a stream of its own.

    A chunk's copies, dequant, cull, kernel and readback all run on its
    entry's stream; a ring of one entry runs on the caller's current
    stream.  The counter lives as long as the ring and is taken under a
    lock, so the chunks of successive (and concurrent) enqueue calls
    alternate entries; the reference restarts at entry 0 on every call.
    """

    def __init__(self, devices):
        self.devices = resolve_devices(devices)
        several = len(self.devices) > 1
        self.streams = [
            torch.cuda.Stream(device=d) if several and d.type == "cuda"
            else None
            for d in self.devices
        ]
        self._lock = threading.Lock()
        self._next = 0

    def __len__(self) -> int:
        return len(self.devices)

    def take(self) -> int:
        """The entry for the next chunk."""
        with self._lock:
            entry = self._next
            self._next = (entry + 1) % len(self.devices)
        return entry

    def stream(self, entry: int):
        """Context that makes `entry`'s stream current (none on the CPU
        or in a ring of one)."""
        stream = self.streams[entry]
        if stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(stream)


class _Readback:
    """One chunk's result on its way to the host.

    On CUDA the device-to-host copy is queued right behind the chunk's
    kernels into pinned memory, with an event after it; `numpy()` waits
    on that event only, not on chunks queued later.
    """

    def __init__(self, out: torch.Tensor):
        if out.device.type == "cuda":
            self._readback = torch.empty(
                out.shape, dtype=out.dtype, pin_memory=True
            )
            self._readback.copy_(out, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(out.device))
        else:
            self._readback = out
            self._event = None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        out = self._readback.numpy()
        return out.view(np.uint16) if out.dtype == np.int16 else out


def _compute_fused(structures, *, probe: float, n_points: int,
                   ring: DeviceRing, routes: RouteCounts
                   ) -> "_FusedPending":
    """Dispatch every chunk of `structures` without synchronizing.

    Chunks by the atom-slot budget, longest structure first; a chunk
    splits so that every structure takes the narrowest wire it can (see
    the module docstring).  The reference pads each chunk to one of a few
    slot buckets because each shape is a separate TPU compile; the CUDA
    kernel takes any multiple of 128 slots, so chunks are not padded.

    Chunks are independent, so they go round-robin over `ring`'s entries
    with no collective.
    """
    order = sorted(
        range(len(structures)), key=lambda i: -structures[i][0].shape[0]
    )
    pending = []  # (chunk, offsets, readback, kind)
    fallback: list[int] = []

    def dispatch(route, chunk, offsets, kind, fn, wire, **kw):
        entry = ring.take()
        device = ring.devices[entry]
        with stagestats.stage("dispatch"), ring.stream(entry):
            # Made on whichever stream came first and waited for; the
            # record keeps its memory from reuse while a side stream
            # reads it.
            sphere = _sphere_device(n_points, device)
            if ring.streams[entry] is not None:
                sphere.record_stream(ring.streams[entry])
            # Pinned copies and the readback go on this entry's stream.
            out = fn(*fused_kernel.to_device(wire, device), sphere,
                     n_points=n_points, **kw)
            pending.append((chunk, offsets, _Readback(out), kind))
        routes.add(route, entry)

    def flush(chunk):
        if not chunk:
            return
        triples = []
        for i in chunk:
            coords, radii, gids = structures[i]
            triples.append(
                (coords, radii, _dense_gids(gids, coords.shape[0]))
            )
        # Banded device-cull wires: per-atom-unique gids (the slot index
        # becomes the exclusion id) and at most 127 tiles per structure.
        # Ineligible structures re-flush as their own sub-chunk on the
        # host-cull wires, so one exotic file never drags a whole chunk
        # off the banded path.
        eligible = [
            k for k, t in enumerate(triples)
            if -(-t[0].shape[0] // fused_kernel.ATOM_TILE)
            <= fused_kernel.W_BUCKETS[-1] and _unique_gids(t[2])
        ]
        if 0 < len(eligible) < len(chunk):
            elig = set(eligible)
            flush([chunk[k] for k in eligible])
            flush([chunk[k] for k in range(len(chunk)) if k not in elig])
            return
        if len(eligible) == len(chunk):
            # 6 B/slot q13 wire first; structures whose extent
            # disqualifies them split out onto the q16 wire, so one big
            # structure does not drag a whole chunk onto 8 B/slot.
            q13_ok = [
                k for k, t in enumerate(triples)
                if t[0].shape[0] == 0
                or float((t[0].max(axis=0) - t[0].min(axis=0)).max())
                <= fused_kernel.MAX_Q13_EXTENT
            ]
            if 0 < len(q13_ok) < len(chunk):
                okset = set(q13_ok)
                flush([chunk[k] for k in q13_ok])
                flush([chunk[k] for k in range(len(chunk))
                       if k not in okset])
                return
            max_nt = max(
                -(-t[0].shape[0] // fused_kernel.ATOM_TILE) for t in triples
            )
            w = next(b for b in fused_kernel.W_BUCKETS if b >= max_nt)
            with stagestats.stage("pack"):
                q13 = fused_kernel.pack_structures_q13(triples, probe)
            if q13 is not None:
                *wire, offsets = q13
                dispatch("q13", chunk, offsets, "counts",
                         fused_kernel.fused_sasa_q13_banded, wire, w=w)
                return
            with stagestats.stage("pack"):
                q16 = fused_kernel.pack_structures_q16(triples, probe)
            if q16 is not None:
                *wire, offsets = q16
                dispatch("q16", chunk, offsets, "counts",
                         fused_kernel.fused_sasa_q16_banded, wire, w=w)
                return
        with stagestats.stage("pack"):
            planes, jlist, offsets, failed = fused_kernel.pack_structures(
                triples, probe, n_points
            )
        # Pathologically connected tilings overflow a j-list row: those
        # structures take the list path instead (exactness over speed).
        fallback.extend(chunk[f] for f in failed)
        # Quantized 8 B/slot wire whenever gids are unique per atom and
        # every extent fits the u16 grid; the f32 planes otherwise.
        q = None
        if all(_unique_gids(t[2]) for t in triples):
            spans = [(off[0], off[1]) for off in offsets if off is not None]
            with stagestats.stage("quantize"):
                q = fused_kernel.quantize_packed(planes, spans)
        if q is not None:
            dispatch("host_q16", chunk, offsets, "counts",
                     fused_kernel.fused_sasa_q16, (*q, jlist))
        else:
            dispatch("f32", chunk, offsets, "area",
                     fused_kernel.fused_sasa, (planes, jlist))

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
    return _FusedPending(structures, pending, fallback, probe, n_points,
                         ring, routes)


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

    def __init__(self, structures, pending, fallback, probe, n_points,
                 ring, routes):
        self.structures = structures
        self.pending = pending
        self.fallback = fallback
        self.probe = probe
        self.n_points = n_points
        self.ring = ring
        self.routes = routes
        self.views: list = [None] * len(structures)

    def collect(self) -> list[np.ndarray]:
        with stagestats.stage("unpack"):
            return [
                v() if callable(v) else v for v in self.collect_views()
            ]

    def collect_views(self) -> list:
        """Wait for every chunk; return per-structure entries: a
        CountsView for the counts wires, a zero-argument thunk for the f32
        wire's areas (slice + inverse permutation), an array for the
        structures re-run on the list path."""
        views = self.views
        for chunk, offsets, readback, kind in self.pending:
            with stagestats.stage("device_wait"):
                out_np = readback.numpy()
            for i, off in zip(chunk, offsets):
                if off is None:
                    continue  # rerouted to the list path
                pos, n, inv = off
                if kind == "counts":
                    views[i] = CountsView(
                        out_np, pos, n, inv, self.structures[i][1],
                        self.probe, self.n_points,
                    )
                else:
                    def thunk(out_np=out_np, pos=pos, n=n, inv=inv):
                        return out_np[pos:pos + n][inv].astype(np.float32)

                    views[i] = thunk
        self.pending = []
        if self.fallback:
            # On the first entry's card, as the reference runs it on its
            # default device.
            outs = _compute_list(
                [self.structures[i] for i in self.fallback],
                probe=self.probe, n_points=self.n_points,
                device=self.ring.devices[0], routes=self.routes,
            )
            for i, out in zip(self.fallback, outs):
                views[i] = out
            self.fallback = []
        return views


class _EagerPending:
    """Already-resolved handle (list backend, empty inputs)."""

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


def _batch_cap(n_pad: int) -> int:
    """Structures per list-path batch, bounded by the [N, N] distance
    matrix and the flattened occlusion working set."""
    cap_d2 = max(1, int(3e8 // (n_pad * n_pad)))
    cap_occ = max(1, int(1.6e8 // (n_pad * _K_CHUNK * 128)))
    return max(1, min(256, cap_d2, cap_occ))


def _pack(n_pad: int, structures):
    """[B, n_pad, 4] x, y, z, radius and [B, n_pad] gids (-1 = padding)."""
    b = len(structures)
    packed = np.zeros((b, n_pad, 4), dtype=np.float32)
    g = np.full((b, n_pad), -1, dtype=np.int32)
    for i, (coords, radii, gids) in enumerate(structures):
        n = coords.shape[0]
        packed[i, :n, 0:3] = coords
        packed[i, :n, 3] = radii
        g[i, :n] = _dense_gids(gids, n)
    return packed, g


def _compute_list(structures, *, probe: float, n_points: int,
                  device: torch.device, routes: RouteCounts
                  ) -> list[np.ndarray]:
    """List path over many structures: bucketed by padded size, batched,
    every batch dispatched before the first readback; batches whose
    candidate count overflowed K re-run with a larger K bucket."""
    results: list = [None] * len(structures)
    buckets: dict[int, list[int]] = {}
    for i, (coords, _, _) in enumerate(structures):
        n = coords.shape[0]
        if n == 0:
            results[i] = np.zeros(0, np.float32)
            continue
        buckets.setdefault(
            neighbors._round_bucket(n, neighbors._N_BUCKETS), []
        ).append(i)
    sphere = _sphere_device(n_points, device)

    def run(packed, g, k):
        routes.add("list")
        return neighbors._sasa_batched(
            packed, g, sphere, k=k, n_points=n_points, probe=probe
        )

    pending = []
    for n_pad, members in sorted(buckets.items()):
        cap = _batch_cap(n_pad)
        for lo in range(0, len(members), cap):
            chunk = members[lo:lo + cap]
            packed, g = (
                torch.from_numpy(a).to(device)
                for a in _pack(n_pad, [structures[i] for i in chunk])
            )
            k = neighbors._initial_k(n_pad)
            pending.append((chunk, packed, g, k, n_pad, *run(packed, g, k)))

    for chunk, packed, g, k, n_pad, sasa, mc in pending:
        mc_val = int(mc)
        while mc_val > k:
            k = min(neighbors._round_bucket(mc_val, neighbors._K_BUCKETS),
                    n_pad)
            sasa, mc = run(packed, g, k)
            mc_val = int(mc)
        sasa_np = sasa.cpu().numpy()
        for slot, i in enumerate(chunk):
            results[i] = sasa_np[slot, :structures[i][0].shape[0]]
    return results


def calculate_sasa_internal(
    coords: np.ndarray,
    radii: np.ndarray,
    *,
    group_ids: np.ndarray | None = None,
    probe_radius: float = DEFAULT_PROBE_RADIUS,
    n_points: int = DEFAULT_N_POINTS,
    backend: str = "auto",
    device="cuda",
) -> np.ndarray:
    """Per-atom SASA for one structure (reference API: lib.rs:249-298).

    coords: [N, 3] positions in Angstroms.  radii: [N] atomic radii.
    group_ids: optional [N] int ids; atoms sharing an id never occlude
    each other.  When omitted every atom gets a distinct id.
    backend: "auto" | "fused" | "list" (see resolve_backend).
    """
    dev = _device(device)
    backend = resolve_backend(backend, n_points)
    coords = np.ascontiguousarray(coords, dtype=np.float32)
    radii = np.ascontiguousarray(radii, dtype=np.float32)
    n = coords.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    gid = _dense_gids(group_ids, n)
    probe = float(probe_radius)
    if backend == "fused":
        return _compute_fused(
            [(coords, radii, gid)], probe=probe, n_points=n_points,
            ring=DeviceRing([dev]), routes=RouteCounts(),
        ).collect()[0]

    n_pad = neighbors._round_bucket(n, neighbors._N_BUCKETS)
    packed, g = (torch.from_numpy(a[0]).to(dev)
                 for a in _pack(n_pad, [(coords, radii, gid)]))
    sphere = _sphere_device(n_points, dev)
    k = neighbors._initial_k(n_pad)
    while True:
        sasa, max_count = neighbors._sasa_single(
            packed, g, sphere, k=k, n_points=n_points, probe=probe
        )
        mc = int(max_count)
        if mc <= k:
            break
        # Exactness: re-run with a K bucket that fits every in-range
        # neighbor; silent truncation would corrupt results.
        k = min(neighbors._round_bucket(mc, neighbors._K_BUCKETS), n_pad)
    return sasa[:n].cpu().numpy()


def _warm_chunk(m: int, w: int, n_points: int, device, stream) -> None:
    """One all-padding q13 chunk of `m` slots at band width `w` through
    fused_sasa_q13_banded on the current stream (`stream`, None for the
    caller's), from zeros made on `device`; waits for 8 counts."""
    tiles = m // fused_kernel.ATOM_TILE
    sphere = _sphere_device(n_points, device)
    if stream is not None:
        sphere.record_stream(stream)
    out = fused_kernel.fused_sasa_q13_banded(
        torch.zeros(m, dtype=torch.int32, device=device),
        torch.zeros(m, dtype=torch.int16, device=device),
        torch.zeros(256, dtype=torch.float32, device=device),
        torch.zeros((tiles, 4), dtype=torch.float32, device=device),
        torch.zeros((tiles, 2), dtype=torch.int32, device=device),
        sphere, n_points=n_points, w=w,
    )
    out[0:8].cpu()


class BatchedSasaEngine:
    """Batched engine: many structures per device dispatch.

    Feed with (coords, radii, group_ids) triples.  On the fused backend
    `enqueue` packs and dispatches every chunk without synchronizing and
    returns a handle whose `collect_views()`/`collect()` are the readback;
    the list backend computes eagerly.  `routes` counts the dispatches of
    each route, and of each device entry.

    `device` (default "cuda": every visible card, in index order) or
    `devices` (a list of entries) goes through `resolve_devices`; the fused
    chunks are dealt round-robin over the entries, each CUDA entry of a
    ring of several with its own stream.  "cuda:N" is one card, "cpu" the
    plain versions.  The list path runs on the first entry's card,
    `self.device`.
    """

    def __init__(self, params: SasaParams | None = None,
                 backend: str = "auto", *, device=None, devices=None):
        if device is not None and devices is not None:
            raise ValueError("pass device= or devices=, not both")
        self.params = params or SasaParams()
        self.backend = resolve_backend(backend, self.params.n_points)
        self.ring = DeviceRing(
            ("cuda" if device is None else device)
            if devices is None else devices
        )
        self.device = self.ring.devices[0]
        self.routes = RouteCounts(len(self.ring))

    # Production (M, w) chunk shapes (the reference's list,
    # rustsasa_tpu/ops/engine.py:867-871): the pipeline's 0.5M and 1M
    # slot chunks and full 2M ones, at the band widths proteome-scale
    # structures land in.
    _WARM_SHAPES = [
        (524288, 16), (524288, 24), (524288, 32),
        (1048576, 16), (1048576, 24), (1048576, 32),
        (2097152, 16), (2097152, 24), (2097152, 32),
    ]

    def warm_shapes(self, shapes=None, *, threads: int | None = None
                    ) -> float:
        """Make each production chunk shape's first launch before real
        work arrives; returns the elapsed seconds.

        On a card that first launch loads the kernels' modules (CUDA
        loads them lazily) and grows the caching allocator to the
        chunk's size.  For each (M, w) of `shapes` (default
        `_WARM_SHAPES`) and each CUDA entry of the ring, on the entry's
        stream, one all-padding q13 chunk goes through
        `fused_sasa_q13_banded` (dequant_boxes, band_jlist, fused_count)
        from zeros made on the device, so no wire bytes cross the bus,
        and 8 counts are read back.  `threads`: one a shape by default;
        <= 1 runs the shapes serially (scripts/precompile_fused.py times
        the two against each other).  An engine with no CUDA entry, or
        on the list backend, has nothing to warm and returns 0.0.
        """
        import time
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.perf_counter()
        entries = [e for e, d in enumerate(self.ring.devices)
                   if d.type == "cuda"]
        if not entries or self.backend != "fused":
            return 0.0
        n_points = self.params.n_points

        def one(shape):
            for entry in entries:
                with self.ring.stream(entry):
                    _warm_chunk(*shape, n_points, self.ring.devices[entry],
                                self.ring.streams[entry])

        shapes = shapes or self._WARM_SHAPES
        if threads is None:
            threads = len(shapes)
        if threads <= 1:
            for shape in shapes:
                one(shape)
        else:
            with ThreadPoolExecutor(max_workers=threads) as pool:
                list(pool.map(one, shapes))
        return time.perf_counter() - t0

    @property
    def chunks_dispatched(self) -> int:
        """Chunks sent through the count kernel, one launch each."""
        c = self.routes.counts
        return c["q13"] + c["q16"] + c["host_q16"] + c["f32"]

    def compute(self, structures) -> list[np.ndarray]:
        return self.enqueue(structures).collect()

    def enqueue(self, structures):
        """Dispatch all device work for `structures`.

        Returns a handle with .collect() -> list[np.ndarray] and
        .collect_views() -> per-structure CountsView / thunk / array
        (empty structures get an empty array).  On the fused backend the
        host is free between enqueue and collect.
        """
        if not structures:
            return _EagerPending([])
        probe = float(self.params.probe_radius)
        n_points = self.params.n_points
        if self.backend == "list":
            return _EagerPending(_compute_list(
                structures, probe=probe, n_points=n_points,
                device=self.device, routes=self.routes,
            ))
        nonempty = [
            i for i, s in enumerate(structures) if s[0].shape[0] > 0
        ]
        inner = _compute_fused(
            [structures[i] for i in nonempty], probe=probe,
            n_points=n_points, ring=self.ring, routes=self.routes,
        )
        return _MappedPending(inner, nonempty, len(structures))
