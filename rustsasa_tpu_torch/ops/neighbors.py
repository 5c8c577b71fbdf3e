"""Neighbor-list SASA path in PyTorch: exact candidate lists + occlusion.

Port of the list path of `rustsasa_tpu/ops/engine.py` (`_neighbor_phase`,
`_occlusion_sasa`, `_sasa_single`, `_sasa_batched`).  It takes what the
fused wires cannot: spheres of more than 2048 points (the analytic tier
runs 50,000) and structures whose host-cull j-lists overflow.

  1. Neighbor phase: pairwise d^2 by the |a|^2 + |b|^2 - 2ab^T expansion,
     the cross term as the fused multiply-add chain the reference's
     HIGHEST dot computes (`fma.dot3`); every atom within r_i + max_r +
     2 probe is a candidate, and the K nearest are kept.  The caller
     re-runs with a larger K while any row has more candidates than K:
     no silent truncation.  On CUDA this is `csrc/neighbor_cells.cu` over
     a whole [B, N] batch: its cell binning and ordering (`cell_keys`,
     whose plain version is `cell_order_reference`: `cell_grid`, a stable
     sort and the sorted gathers), and its cell-list kernel, which writes
     the records K-major, as the occlusion kernel reads them;
     `neighbor_records_reference` is the plain-torch version (the dense
     expansion and top-k of `_neighbor_phase`, structure by structure),
     taken only for CPU tensors.
  2. Occlusion: point s of atom i is occluded iff some neighbor k has
     (sx*vx + sy*vy) + sz*vz < limit_k.  On CUDA this is the hand-written
     kernel `csrc/list_occlusion.cu` (replacing the Pallas
     `_occlusion_tile_kernel`); `occlusion_sasa_reference` is its
     plain-torch version, taken only for CPU tensors.

Every float expression keeps the reference's operation order with
separate multiplies and adds, so the records and the occlusion are
byte-equal to the reference's on the same inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import _kernels
from .fma import dot3

ATOM_TILE = 128
_NEG_BIG = -1e30

# Candidate-selection slack: the distance expansion loses a few ulps to
# cancellation; widening the cutoff only ever adds candidates, and the
# occlusion test recomputes v exactly.
_CUTOFF_SLACK = float(np.float32(1e-3))

# Atom-count and neighbor-count buckets (reference engine._N_BUCKETS,
# _K_BUCKETS): padded shapes repeat, and K grows in steps on overflow.
_N_BUCKETS = [
    8, 16, 32, 64, 128, 256, 384, 512, 768, 1024, 1536, 2048, 3072,
    4096, 6144, 8192, 12288, 16384, 24576, 32768, 49152, 65536,
]
_K_BUCKETS = [16, 32, 64, 96, 128, 160, 192, 256, 320, 384, 512]

# Above this atom count the plain version builds its [N, N] working set
# in row blocks.
_DENSE_N_LIMIT = 8192
_ROW_CHUNK = 4096

# (k, atom, point) margins the plain-torch occlusion materializes per block.
REFERENCE_BLOCK_ELEMS = 1 << 25

# The cell list of csrc/neighbor_cells.cu.  An atom's key is (structure
# << 54) | (cell x << 36) | (cell y << 18) | cell z, padding atoms
# PAD_KEY (they sort last); a batch holds at most
# _kernels.MAX_CELL_BATCH structures, so no real key reaches PAD_KEY's
# structure field.
CELL_BITS = 18
CELL_MAX = (1 << CELL_BITS) - 1
PAD_KEY = (1 << 63) - 1
# The cell edge h of a structure: h^2 = (thr + D2_ERR * (R^2 + thr)) *
# (1 + H_SLACK), thr = (2 max_r + 2 probe)^2 + 1e-3 the widest candidate
# cutoff, R the largest |c| of its atoms.  csrc/neighbor_cells.cu derives
# |d2 - |c_i - c_j|^2| <= 14.04 u R^2 + u |c_i - c_j|^2 (u = 2^-24) for
# the expansion; D2_ERR = 32 u covers it and the f32 cutoff's rounding,
# H_SLACK the f64 cell arithmetic.  A candidate pair is then at most h
# apart on every axis, one cell at most.
D2_ERR = 2.0 ** -19
H_SLACK = 2.0 ** -20


def _round_bucket(n: int, buckets: list[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(math.ceil(n / buckets[-1])) * buckets[-1]


def _initial_k(n: int) -> int:
    # ~130 in-range neighbors is typical for protein packing with ProtOr
    # radii and probe 1.4; 160 fits dense cores without a re-run.
    return min(_round_bucket(min(160, n), _K_BUCKETS), n)


def _sum3(x):
    """Sum over a trailing axis of 3 in the reference's order."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _pair_d2(a, b):
    """d^2 = max((|a|^2 + |b|^2) - 2 a.b, 0) of atoms a and b [..., 3]
    (broadcast), a.b as fma(z, z', fma(y, y', x x'))."""
    cross = dot3(a[..., 0], b[..., 0], a[..., 1], b[..., 1], a[..., 2],
                 b[..., 2])
    return torch.clamp_min((_sum3(a * a) + _sum3(b * b)) - 2.0 * cross, 0.0)


def _candidates(lo_coords, lo_radii, lo_gid, coords, group_id, max_radius,
                probe: float):
    """(d2, cand) [rows, N] of row atoms against one structure's columns:
    cand where both atoms are real, their group ids differ and d2 <=
    ((r_i + max_r) + 2 probe)^2 + slack."""
    d2 = _pair_d2(lo_coords[:, None, :], coords[None, :, :])
    cutoff = (lo_radii + max_radius) + 2.0 * probe
    pair_ok = (
        (lo_gid >= 0)[:, None]
        & (group_id >= 0)[None, :]
        & (lo_gid[:, None] != group_id[None, :])
    )
    return d2, pair_ok & (
        d2 <= cutoff[:, None] * cutoff[:, None] + _CUTOFF_SLACK
    )


def _records(lo_coords, lo_radii, nbr_coords, nbr_radii, probe: float):
    """Row atoms' records against their neighbors [rows, K, 3] and
    [rows, K]: (v = c_i - c_j [rows, K, 3], limit = ((nr^2 - |v|^2) -
    reff_i^2) / (2 reff_i) [rows, K]), nr = r_j + probe, reff_i = r_i +
    probe."""
    v = lo_coords[:, None, :] - nbr_coords
    v2 = _sum3(v * v)
    lo_reff = lo_radii + probe
    nr = nbr_radii + probe
    limit = ((nr * nr - v2) - (lo_reff * lo_reff)[:, None]) / (
        2.0 * lo_reff[:, None]
    )
    return v, limit


def _neighbor_phase(packed, group_id, *, probe: float, k: int):
    """Candidate selection for one structure (plain torch).

    packed: [N, 4] f32 x, y, z, radius; group_id: [N] i32, -1 = padding.
    Returns (v [N, K, 3] = c_i - c_k, limit [N, K] with -1e30 on invalid
    slots, counts [N] i64 candidates per row, max_count 0-d tensor),
    K = min(k, N).  Rows above _DENSE_N_LIMIT go in _ROW_CHUNK blocks.
    """
    coords = packed[:, 0:3]
    radii = packed[:, 3]
    n = coords.shape[0]
    k_eff = min(k, n)
    max_radius = torch.where(group_id >= 0, radii, 0.0).max()

    def rows(lo_coords, lo_radii, lo_gid):
        d2, cand = _candidates(lo_coords, lo_radii, lo_gid, coords, group_id,
                               max_radius, probe)
        counts = cand.sum(dim=1)
        score = torch.where(cand, -d2, _NEG_BIG)
        nbr_idx = torch.topk(score, k_eff, dim=1).indices  # valid first
        nbr_valid = cand.gather(1, nbr_idx)
        v, limit = _records(lo_coords, lo_radii, coords[nbr_idx],
                            radii[nbr_idx], probe)
        return v, torch.where(nbr_valid, limit, _NEG_BIG), counts

    if n <= _DENSE_N_LIMIT or n % _ROW_CHUNK != 0:
        v, limit, counts = rows(coords, radii, group_id)
    else:
        parts = [
            rows(coords[lo:lo + _ROW_CHUNK], radii[lo:lo + _ROW_CHUNK],
                 group_id[lo:lo + _ROW_CHUNK])
            for lo in range(0, n, _ROW_CHUNK)
        ]
        v, limit, counts = (torch.cat(x) for x in zip(*parts))
    return v, limit, counts, counts.max()


def k_major(v, limit, m4: int):
    """[M, K, 3] v and [M, K] limit -> [4, K, m4] planes (vx, vy, vz,
    limit) as the occlusion kernel reads them; columns past M hold
    records that never occlude (v = 0, limit -1e30)."""
    m, k = limit.shape
    planes = torch.zeros((4, k, m4), dtype=torch.float32, device=limit.device)
    planes[:3, :, :m] = v.permute(2, 1, 0)
    planes[3, :, :m] = limit.T
    planes[3, :, m:] = _NEG_BIG
    return planes


def neighbor_records_reference(packed, group_id, *, probe: float, k: int):
    """Plain version of csrc/neighbor_cells.cu: the neighbor phase of a
    [B, N] batch, structure by structure, copied K-major ->
    (planes [4, K, M4] f32, counts [B*N] i32, max_count 0-d i32); M4 is
    B*N rounded up to 4, K = min(k, N)."""
    b, n = group_id.shape
    phases = [_neighbor_phase(packed[i], group_id[i], probe=probe, k=k)
              for i in range(b)]
    v, limit, counts = (torch.cat(x) for x in list(zip(*phases))[:3])
    counts = counts.to(torch.int32)
    return k_major(v, limit, _round_up4(b * n)), counts, counts.max()


def _round_up4(m: int) -> int:
    return m + (-m % 4)


class CellGrid(NamedTuple):
    """The cell list of a [B, N] batch: keys [B*N] i64 by atom (PAD_KEY
    for padding), each structure's largest real radius max_r [B] f32 and
    cell edge h [B] f64."""
    keys: torch.Tensor
    max_r: torch.Tensor
    h: torch.Tensor


def cell_grid(packed, group_id, probe: float) -> CellGrid:
    """Plain version of csrc/neighbor_cells.cu's binning kernel: bin a [B, N]
    batch's real atoms into cells of edge h (f64): cell = floor((c - lo)
    / h) per axis from the structure's lowest corner lo, h as D2_ERR
    says, and no smaller than the structure's span over CELL_MAX - 1
    cells.  Each f64 operation is one IEEE rounding in the order the
    kernel takes (r2 = (x*x + y*y) + z*z, a true division by a tensor,
    a correctly rounded square root), so the keys are the kernel's bit
    for bit on any device."""
    b, n = group_id.shape
    if b > _kernels.MAX_CELL_BATCH:
        raise ValueError(f"{b} structures in a cell-list batch, at most "
                         f"{_kernels.MAX_CELL_BATCH}")
    valid = group_id >= 0
    some = valid.any(dim=1, keepdim=True)
    c = packed[..., 0:3].to(torch.float64)
    max_r = torch.where(valid, packed[..., 3], 0.0).amax(dim=1)
    lo = torch.where(valid[..., None], c, math.inf).amin(dim=1)
    hi = torch.where(valid[..., None], c, -math.inf).amax(dim=1)
    lo, hi = (torch.where(some, t, 0.0) for t in (lo, hi))
    r2 = torch.where(valid, _sum3(c * c), 0.0).amax(dim=1)
    cut = 2.0 * max_r.to(torch.float64) + 2.0 * probe
    thr = cut * cut + 1e-3
    span = (hi - lo).amax(dim=1)
    # NumPy's square root: torch's f64 sqrt on the CPU is not always
    # correctly rounded (one ulp low on some inputs), the kernel's is.
    edge2 = (thr + D2_ERR * (r2 + thr)) * (1.0 + H_SLACK)
    edge = torch.from_numpy(np.sqrt(edge2.cpu().numpy())).to(edge2.device)
    h = torch.maximum(edge, span / torch.full_like(span, CELL_MAX - 1))
    cell = ((c - lo[:, None, :]) / h[:, None, None]).floor().clamp(
        0, CELL_MAX).to(torch.int64)
    key = (
        (torch.arange(b, device=packed.device)[:, None] << 54)
        | (cell[..., 0] << 36) | (cell[..., 1] << 18) | cell[..., 2]
    )
    key = torch.where(valid, key, PAD_KEY)
    return CellGrid(key.reshape(b * n), max_r, h)


def cell_order_reference(packed, group_id, probe: float) -> _kernels.CellOrder:
    """Plain version of csrc/neighbor_cells.cu's cell_keys: cell_grid, a
    stable torch.sort of its keys and packed and group_id gathered into
    that order -> _kernels.CellOrder.  For the tests and the CPU; the
    CUDA path launches the kernel."""
    grid = cell_grid(packed, group_id, probe)
    sorted_keys, perm = torch.sort(grid.keys, stable=True)
    m = group_id.numel()
    return _kernels.CellOrder(
        grid.keys, grid.max_r, grid.h, sorted_keys, perm,
        packed.reshape(m, 4).index_select(0, perm),
        group_id.reshape(m).index_select(0, perm))


def neighbor_records(packed, group_id, *, probe: float, k: int):
    """The neighbor phase of a [B, N] batch -> (planes [4, K, M4] f32 K-major
    vx, vy, vz, limit; counts [B*N] i32; max_count 0-d i32), K = min(k,
    N).  CPU tensors take the plain version; CUDA tensors launch
    csrc/neighbor_cells.cu's cell binning and ordering (cell_keys) and its
    cell-list kernel (or raise), with no readback."""
    if packed.device.type == "cpu":
        return neighbor_records_reference(packed, group_id, probe=probe, k=k)
    if packed.device.type != "cuda":
        raise ValueError(f"neighbor_records: unsupported device "
                         f"{packed.device}")
    order = _kernels.cell_keys(packed, group_id, probe)
    return _kernels.neighbor_cells(
        packed, group_id, order.max_r, order.keys, order.sorted_keys,
        order.perm, order.sorted_packed, order.sorted_gid, probe=probe,
        k=min(k, group_id.shape[1]))


def _area_factor(radii, valid, probe: float, n_points: int):
    """4 pi r_eff^2 / n_points per atom, 0 for padding (reference order)."""
    r_eff = radii + probe
    four_pi = float(np.float32(4.0 * np.float32(np.pi)))
    factor = ((r_eff * four_pi) * r_eff) * float(np.float32(1.0 / n_points))
    return torch.where(valid, factor, 0.0)


def tile_kmax(counts, k_eff: int):
    """Per-128-atom-tile neighbor bound: the tile's largest candidate count,
    clipped to [0, K].  Slots past a row's candidates hold limit -1e30,
    so bounding the loop there changes no result."""
    m = counts.shape[0]
    n_tiles = -(-m // ATOM_TILE)
    padded = torch.zeros(n_tiles * ATOM_TILE, dtype=counts.dtype,
                         device=counts.device)
    padded[:m] = counts
    kmax = padded.reshape(n_tiles, ATOM_TILE).amax(dim=1)
    return torch.clamp(kmax, 0, k_eff).to(torch.int32)


def occlusion_sasa_reference(vx, vy, vz, limit, area, sphere, kmax):
    """Plain-torch list-path occlusion -> per-atom SASA [N] f32.

    vx, vy, vz, limit: [K, N] f32, K-major; area: [N] f32; sphere: [P, 4]
    f32 (x, y, z, valid); kmax: [ceil(N/128)] i32 per-tile neighbor bound.
    Point p of atom i is occluded iff some k < kmax[i // 128] has
    (sx*vx + sy*vy) + sz*vz < limit; SASA = valid unoccluded points * area.
    Works in blocks of at most REFERENCE_BLOCK_ELEMS (k, atom, point).
    """
    k, n = limit.shape
    dev = limit.device
    p = sphere.shape[0]
    sx, sy, sz = sphere[:, 0], sphere[:, 1], sphere[:, 2]
    kmax = torch.clamp(kmax.to(torch.int64), 0, k)
    atom_kmax = kmax.repeat_interleave(ATOM_TILE)[:n]
    occ = torch.zeros((n, p), dtype=torch.bool, device=dev)
    k_top = int(kmax.max()) if kmax.numel() else 0
    kc = max(1, REFERENCE_BLOCK_ELEMS // max(1, n * p))
    for k0 in range(0, k_top, kc):
        ks = slice(k0, min(k_top, k0 + kc))
        x, y, z, lim = (a[ks, :, None] for a in (vx, vy, vz, limit))
        dots = (sx * x + sy * y) + sz * z  # [kc, N, P]
        live = (torch.arange(ks.start, ks.stop, device=dev)[:, None]
                < atom_kmax[None, :])
        occ |= ((dots < lim) & live[:, :, None]).any(dim=0)
    accessible = ((sphere[:, 3] > 0.0) & ~occ).sum(dim=1, dtype=torch.float32)
    return accessible * area


def occlusion_planes(vx, vy, vz, limit, area, sphere, kmax):
    """List-path occlusion + area on K-major records [K, M] (M a multiple
    of 4 on CUDA) -> per-atom SASA [M] f32.  CPU tensors take the
    plain-torch version; CUDA tensors launch the hand-written kernel (or
    raise) and never fall back."""
    if limit.device.type == "cpu":
        return occlusion_sasa_reference(vx, vy, vz, limit, area, sphere, kmax)
    if limit.device.type != "cuda":
        raise ValueError(f"occlusion_planes: unsupported device "
                         f"{limit.device}")
    return _kernels.list_occlusion(vx, vy, vz, limit, area, sphere, kmax)


def occlusion_sasa(v, limit, area, sphere, kmax):
    """List-path occlusion + area: v [N, K, 3], limit [N, K], area [N],
    sphere [P, 4], kmax per 128-atom tile -> per-atom SASA [N] f32.

    Mirrors the reference's `occlusion_sasa_pallas`: the records go
    K-major (k_major, padded to a multiple of 4 atoms with records that
    never occlude), so one neighbor step reads one contiguous row of
    atoms, then occlusion_planes.
    """
    n = limit.shape[0]
    m4 = _round_up4(n)
    area = torch.nn.functional.pad(area, (0, m4 - n))
    return occlusion_planes(*k_major(v, limit, m4), area, sphere, kmax)[:n]


def _sasa_single(packed, group_id, sphere, *, k: int, n_points: int,
                 probe: float):
    """One padded structure -> (per-atom SASA [N], max_count tensor)."""
    sasa, max_count = _sasa_batched(packed[None], group_id[None], sphere,
                                    k=k, n_points=n_points, probe=probe)
    return sasa[0], max_count


def records_sasa(records, packed, group_id, sphere, *, probe: float,
                 n_points: int):
    """Per-atom SASA [M4] of a [B, N] batch from its neighbor records
    (planes, counts, max_count): the area factor, the tiles' bounds and
    one flat occlusion over the B * N atoms (zero past them)."""
    planes, counts, _ = records
    m = group_id.numel()
    area = _area_factor(packed[..., 3].reshape(m), group_id.reshape(m) >= 0,
                        probe, n_points)
    area = torch.nn.functional.pad(area, (0, planes.shape[2] - m))
    kmax = tile_kmax(counts, planes.shape[1])
    return occlusion_planes(*planes, area, sphere.contiguous(), kmax)


def _sasa_batched(packed, group_id, sphere, *, k: int, n_points: int,
                  probe: float):
    """[B, N, ...] batch: one neighbor phase over the batch (one kernel
    on CUDA), then one flat occlusion over the B * N atoms -> (SASA
    [B, N], max_count tensor)."""
    b, n = group_id.shape
    records = neighbor_records(packed, group_id, probe=probe, k=k)
    sasa = records_sasa(records, packed, group_id, sphere, probe=probe,
                        n_points=n_points)
    return sasa[:b * n].reshape(b, n), records[2]
