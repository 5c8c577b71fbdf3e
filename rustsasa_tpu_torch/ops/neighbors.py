"""Neighbor-list SASA path in PyTorch: exact candidate lists + occlusion.

Port of the list path of `rustsasa_tpu/ops/engine.py` (`_neighbor_phase`,
`_occlusion_sasa`, `_sasa_single`, `_sasa_batched`).  It takes what the
fused wires cannot: spheres of more than 2048 points (the analytic tier
runs 50,000) and structures whose host-cull j-lists overflow.

  1. Neighbor phase: pairwise d^2 by the |a|^2 + |b|^2 - 2ab^T expansion
     (a full-FP32 matmul), every atom within r_i + max_r + 2 probe is a
     candidate, and the K nearest are kept by top-k.  The caller re-runs
     with a larger K while any row has more candidates than K: no silent
     truncation.
  2. Occlusion: point s of atom i is occluded iff some neighbor k has
     (sx*vx + sy*vy) + sz*vz < limit_k.  On CUDA this is the hand-written
     kernel `csrc/list_occlusion.cu` (replacing the Pallas
     `_occlusion_tile_kernel`); `occlusion_sasa_reference` is its
     plain-torch version, taken only for CPU tensors.

Every float expression keeps the reference's operation order with
separate multiplies and adds, so the occlusion is byte-equal to the
Pallas kernel on the same neighbor records.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _kernels

ATOM_TILE = 128
_NEG_BIG = -1e30

# Candidate-selection slack: the matmul distance expansion loses a few
# ulps to cancellation; widening the cutoff only ever adds candidates,
# and the occlusion test recomputes v exactly.
_CUTOFF_SLACK = float(np.float32(1e-3))

# Atom-count and neighbor-count buckets (reference engine._N_BUCKETS,
# _K_BUCKETS): padded shapes repeat, and K grows in steps on overflow.
_N_BUCKETS = [
    8, 16, 32, 64, 128, 256, 384, 512, 768, 1024, 1536, 2048, 3072,
    4096, 6144, 8192, 12288, 16384, 24576, 32768, 49152, 65536,
]
_K_BUCKETS = [16, 32, 64, 96, 128, 160, 192, 256, 320, 384, 512]

# Above this atom count the [N, N] working set is built in row blocks.
_DENSE_N_LIMIT = 8192
_ROW_CHUNK = 4096

# (k, atom, point) margins the plain-torch occlusion materializes per block.
REFERENCE_BLOCK_ELEMS = 1 << 25


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


def _check_full_fp32(t: torch.Tensor) -> None:
    """The d^2 expansion must not run in TF32: with |coords| ~ 1e2 its
    ~1e-3 relative error would silently drop true neighbors."""
    if t.device.type == "cuda" and (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "the neighbor phase needs full-FP32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )


def _neighbor_phase(packed, group_id, *, probe: float, k: int):
    """Candidate selection for one structure.

    packed: [N, 4] f32 x, y, z, radius; group_id: [N] i32, -1 = padding.
    Returns (v [N, K, 3] = c_i - c_k, limit [N, K] with -1e30 on invalid
    slots, counts [N] i64 candidates per row, max_count 0-d tensor),
    K = min(k, N).  Rows above _DENSE_N_LIMIT go in _ROW_CHUNK blocks.
    """
    _check_full_fp32(packed)
    coords = packed[:, 0:3]
    radii = packed[:, 3]
    valid = group_id >= 0
    n = coords.shape[0]
    k_eff = min(k, n)
    max_radius = torch.where(valid, radii, 0.0).max()
    sq = _sum3(coords * coords)

    def rows(lo_coords, lo_radii, lo_gid, lo_sq):
        cross = torch.matmul(lo_coords, coords.T)
        d2 = torch.clamp_min(
            (lo_sq[:, None] + sq[None, :]) - 2.0 * cross, 0.0
        )
        cutoff = (lo_radii + max_radius) + 2.0 * probe
        pair_ok = (
            (lo_gid >= 0)[:, None]
            & valid[None, :]
            & (lo_gid[:, None] != group_id[None, :])
        )
        cand = pair_ok & (
            d2 <= cutoff[:, None] * cutoff[:, None] + _CUTOFF_SLACK
        )
        counts = cand.sum(dim=1)
        score = torch.where(cand, -d2, _NEG_BIG)
        nbr_idx = torch.topk(score, k_eff, dim=1).indices  # valid first
        nbr_valid = cand.gather(1, nbr_idx)
        v = lo_coords[:, None, :] - coords[nbr_idx]
        v2 = _sum3(v * v)
        lo_reff = lo_radii + probe
        nr = radii[nbr_idx] + probe
        limit = ((nr * nr - v2) - (lo_reff * lo_reff)[:, None]) / (
            2.0 * lo_reff[:, None]
        )
        limit = torch.where(nbr_valid, limit, _NEG_BIG)
        return v, limit, counts

    if n <= _DENSE_N_LIMIT or n % _ROW_CHUNK != 0:
        v, limit, counts = rows(coords, radii, group_id, sq)
    else:
        parts = [
            rows(coords[lo:lo + _ROW_CHUNK], radii[lo:lo + _ROW_CHUNK],
                 group_id[lo:lo + _ROW_CHUNK], sq[lo:lo + _ROW_CHUNK])
            for lo in range(0, n, _ROW_CHUNK)
        ]
        v, limit, counts = (torch.cat(x) for x in zip(*parts))
    return v, limit, counts, counts.max()


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


def occlusion_sasa(v, limit, area, sphere, kmax):
    """List-path occlusion + area: v [N, K, 3], limit [N, K], area [N],
    sphere [P, 4], kmax per 128-atom tile -> per-atom SASA [N] f32.

    Mirrors the reference's `occlusion_sasa_pallas`: the neighbor records
    go K-major, so one neighbor step reads one contiguous row of atoms.
    CPU tensors take the plain-torch version; CUDA tensors launch the
    hand-written kernel (or raise) and never fall back.  The kernel takes
    N a multiple of 4: on CUDA the copies are padded to one with records
    that never occlude (v = 0, limit = 0) and the result cut back to N.
    """
    if v.device.type == "cpu":
        vx, vy, vz = (v[:, :, a].T.contiguous() for a in range(3))
        return occlusion_sasa_reference(vx, vy, vz, limit.T.contiguous(),
                                        area, sphere, kmax)
    if v.device.type != "cuda":
        raise ValueError(f"occlusion_sasa: unsupported device {v.device}")
    n = limit.shape[0]
    pad = -n % 4
    vx, vy, vz, lim = (torch.nn.functional.pad(t.T, (0, pad)).contiguous()
                       if pad else t.T.contiguous()
                       for t in (v[:, :, 0], v[:, :, 1], v[:, :, 2], limit))
    if pad:
        area = torch.nn.functional.pad(area, (0, pad))
    return _kernels.list_occlusion(vx, vy, vz, lim, area, sphere, kmax)[:n]


def _occlusion_sasa(v, limit, counts, radii, valid, sphere, *, probe: float,
                    n_points: int):
    """Area factor + per-tile bound + occlusion for flat [M, K] records."""
    area = _area_factor(radii, valid, probe, n_points)
    kmax = tile_kmax(counts, limit.shape[1])
    return occlusion_sasa(v, limit, area, sphere.contiguous(), kmax)


def _sasa_single(packed, group_id, sphere, *, k: int, n_points: int,
                 probe: float):
    """One padded structure -> (per-atom SASA [N], max_count tensor)."""
    v, limit, counts, max_count = _neighbor_phase(
        packed, group_id, probe=probe, k=k
    )
    sasa = _occlusion_sasa(
        v, limit, counts, packed[:, 3], group_id >= 0, sphere,
        probe=probe, n_points=n_points,
    )
    return sasa, max_count


def _sasa_batched(packed, group_id, sphere, *, k: int, n_points: int,
                  probe: float):
    """[B, N, ...] batch: per-structure neighbor phases, then one flat
    occlusion over the B * N atoms -> (SASA [B, N], max_count tensor)."""
    b, n = group_id.shape
    phases = [
        _neighbor_phase(packed[i], group_id[i], probe=probe, k=k)
        for i in range(b)
    ]
    v, limit, counts = (torch.cat(x) for x in list(zip(*phases))[:3])
    sasa = _occlusion_sasa(
        v, limit, counts, packed[:, :, 3].reshape(b * n),
        group_id.reshape(b * n) >= 0, sphere,
        probe=probe, n_points=n_points,
    )
    max_count = torch.stack([ph[3] for ph in phases]).max()
    return sasa.reshape(b, n), max_count
