"""Fused occlusion-count path in PyTorch: wire dequant, culls, counts.

Port of `rustsasa_tpu/ops/fused_kernel.py`: the banded q13 and q16 wires
(culled on the device) and the host-cull wires for what the banded path
cannot take (q16 with host j-lists, and the f32 planes with real group
ids).  The host halves (packers) are the reference's numpy spec copied
verbatim, because the reference module imports JAX at its top; a test
pins the copies to the originals.  On the card a banded chunk runs three
hand-written CUDA kernels (bound in `_kernels.py`), where the reference
runs one jit: `dequant_boxes` (`csrc/band_cull.cu`: the wire dequant and
the cull's boxes), `band_jlist` (the same source: the banded cull and its
nearest-first compaction) and the occlusion count (`csrc/fused_count.cu`,
replacing the Pallas `_fused_count_kernel`).  Each has its plain-torch
version here (`dequant_q13_reference`, `dequant_q16_reference`,
`tile_boxes_reference`, `build_jlist_banded_reference`,
`fused_counts_reference`): the CPU path, and the kernels' reference on
the card.  The count kernel streams only the j-rows some atom of a warp
keeps under a conservative reach test; `fused_counts_kept_reference` is
the plain model of that skip, and `reach_work` counts the work these
inputs need (the kernel's bound).

Counts are held byte-exact against the reference at every real atom
slot, so every float expression below keeps the reference's operation
order with separate multiplies and adds (no `addcmul`, no
`torch.compile`): a fused multiply-add rounds once where the reference
rounds twice and would flip boundary sphere points.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels

ATOM_TILE = 128
_NEG_BIG = -1e30

# planes rows: x, y, z, r_eff, gid(+1, 0=padding), unused*3
N_PLANES = 8
# j-list column layout (u32 bits in i32): col 0 = count, cols 1..count =
# entries (group_mask << 16) | j_tile_id.  Mask bit g covers j-atoms
# [8g, 8g+8) of that tile.
JLIST_ROWS = 128
JLIST_CAP = JLIST_ROWS - 1
# j-atoms per masked group.
J_GROUP = 8
GROUPS_PER_TILE = ATOM_TILE // J_GROUP


class JListOverflow(ValueError):
    """An i-tile has more than JLIST_CAP in-reach j-tiles."""


# Rows of the f32 host-cull wire: x, y, z, r_eff, gid(+1).
N_XFER_PLANES = 5

# Fixed radius dequant scale: r_eff = qr * 2^-13 (exact in f32).
R_QUANT = 8192.0
# Structures above this extent take the q16 wire (reference
# fused_kernel.MAX_Q13_EXTENT).
MAX_Q13_EXTENT = 100.0
# Band widths of the device-side cull; 127 = JLIST_CAP, so a full band
# never overflows a j-list row.
W_BUCKETS = (16, 24, 32, 64, 127)
# Slack of the device-side AABB cull (the cull and the kernel read the
# same dequantized f32 coordinates; only f32 rounding needs covering).
DEVICE_CULL_SLACK = 0.01
# Slack of the host cull (pack_structures), which must stay conservative
# under the u16 quantization the kernel may then see (quantize_packed).
CULL_SLACK = 0.08
MAX_Q_EXTENT = 1300.0
# Largest padded sphere the count kernel takes (reference
# pallas_kernel.MAX_P_PAD); more points need the neighbor-list path.
MAX_P_PAD = _kernels.MAX_P_PAD
# Margins (j, i, point) the plain-torch counts materialize per block, by
# device: a block that stays in cache runs ~2x faster on the CPU.
REFERENCE_BLOCK_ELEMS = {"cuda": 1 << 25, "cpu": 1 << 22}


def pack_structures_q13(structures: list, probe: float):
    """Host packing for the 6 B/slot q13 wire (numpy spec).

    Same contract as pack_structures_q16 but returns
    (wire_a [M] u32, wire_b [M] u16, palette [256] f32, tparams, tmeta,
    offsets), or None when any structure is ineligible (extent >
    MAX_Q13_EXTENT, or more than 255 distinct r_eff values in the chunk
    — e.g. occupancy-column radii) — the caller falls back to q16.
    The native C++ packer (fastpack_q13) implements the same layout.
    """
    from ..native import fastpack_q13

    out = fastpack_q13(structures, float(probe))
    if out is not None:
        return out if out != "ineligible" else None
    return _pack_structures_q13_numpy(structures, probe)


def _pack_structures_q13_numpy(structures: list, probe: float):
    tiles_per = [-(-s[0].shape[0] // ATOM_TILE) for s in structures]
    total_tiles = sum(tiles_per)
    if total_tiles > 65535:
        raise ValueError(
            f"chunk too large for u16 tile ids: {total_tiles} tiles"
        )
    m = total_tiles * ATOM_TILE
    wire_a = np.zeros(m, dtype=np.uint32)
    wire_b = np.zeros(m, dtype=np.uint16)
    tparams = np.zeros((total_tiles, 4), dtype=np.float32)
    tparams[:, 3] = 1.0
    tmeta = np.zeros((total_tiles, 2), dtype=np.int32)

    # Chunk-global radius palette, keyed by the exact qr bucket (1/8192 A
    # grid — ProtOr radii are spaced >= 0.01 A so buckets never collide).
    # Index 0 is reserved to mark padding slots.
    qr_to_idx = np.zeros(65536, dtype=np.uint16)
    palette = np.zeros(256, dtype=np.float32)
    n_pal = 1

    offsets = []
    tile0 = 0
    pos = 0
    for coords, radii, _gids in structures:
        n = coords.shape[0]
        nt = -(-n // ATOM_TILE)
        center = np.round(
            coords.mean(axis=0, dtype=np.float64) * 256.0
        ) / 256.0
        c = coords - center.astype(np.float32)
        order = np.argsort(_morton_codes(c), kind="stable")
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)
        c = c[order]
        r_eff = (radii[order] + np.float32(probe)).astype(np.float32)

        cmin = c.min(axis=0)
        extent = float((c.max(axis=0) - cmin).max())
        if not extent <= MAX_Q13_EXTENT:  # NaN-safe negation
            return None
        scale = np.float32(max(extent, 1e-6) / 8191.0)
        q = np.clip(
            np.rint((c - cmin[None, :]) / scale), 0, 8191
        ).astype(np.uint32)

        qr = np.rint(r_eff * R_QUANT)
        if not (
            float(qr.max(initial=0.0)) <= 65535.0
            and float(qr.min(initial=1.0)) >= 1.0
        ):  # NaN-safe negation
            return None
        qr = qr.astype(np.int64)
        # Palette registration in INPUT-atom order (first-seen), exactly
        # like the native packer's prescan, so both emit identical bytes.
        r_in = (np.asarray(radii, dtype=np.float32) + np.float32(probe))
        qr_in = np.rint(r_in * R_QUANT).astype(np.int64)
        uniq, first = np.unique(qr_in, return_index=True)
        for u in uniq[np.argsort(first)]:
            if qr_to_idx[u] == 0:
                if n_pal >= 256:
                    return None
                # Exact f32 value for this bucket (first occurrence).
                palette[n_pal] = r_in[qr_in == u][0]
                qr_to_idx[u] = n_pal
                n_pal += 1
        ridx = qr_to_idx[qr].astype(np.uint32)

        sl = slice(pos, pos + n)
        wire_a[sl] = q[:, 0] | (q[:, 1] << 13) | ((q[:, 2] >> 7) << 26)
        wire_b[sl] = ((q[:, 2] & 0x7F) | (ridx << 7)).astype(np.uint16)
        t0, t1 = tile0, tile0 + nt
        tparams[t0:t1, 0:3] = cmin
        tparams[t0:t1, 3] = scale
        tmeta[t0:t1, 0] = tile0
        tmeta[t0:t1, 1] = nt
        offsets.append((pos, n, inv))
        tile0 += nt
        pos += nt * ATOM_TILE
    return wire_a, wire_b, palette, tparams, tmeta, offsets


def pack_structures_q16(structures: list, probe: float):
    """Host packing for the banded device-cull path (numpy spec).

    Per structure: center (f64 mean rounded to a 1/256 A grid), Morton
    sort, quantize coordinates to u16 against the structure's own box and
    r_eff to u16/8192 - NO neighbor work; culling happens on device
    (build_jlist_banded).  Returns
    (planes4 [4, M] u16, tparams [T, 4] f32, tmeta [T, 2] i32, offsets)
    with offsets[i] = (slot, n, inv), or None when any structure is
    unquantizable (extent > MAX_Q_EXTENT or r_eff >= 8 A) - the caller
    falls back to the f32/host-cull path.  The native C++ packer
    (fastpack_q16) implements the same layout bit-identically.
    """
    from ..native import fastpack_q16

    out = fastpack_q16(structures, float(probe))
    if out is not None:
        return out
    return _pack_structures_q16_numpy(structures, probe)


def _pack_structures_q16_numpy(structures: list, probe: float):
    tiles_per = [-(-s[0].shape[0] // ATOM_TILE) for s in structures]
    total_tiles = sum(tiles_per)
    if total_tiles > 65535:
        raise ValueError(
            f"chunk too large for u16 tile ids: {total_tiles} tiles"
        )
    m = total_tiles * ATOM_TILE
    planes4 = np.zeros((4, m), dtype=np.uint16)
    tparams = np.zeros((total_tiles, 4), dtype=np.float32)
    tparams[:, 3] = 1.0
    tmeta = np.zeros((total_tiles, 2), dtype=np.int32)

    offsets = []
    tile0 = 0
    pos = 0
    for coords, radii, _gids in structures:
        n = coords.shape[0]
        nt = -(-n // ATOM_TILE)
        center = np.round(
            coords.mean(axis=0, dtype=np.float64) * 256.0
        ) / 256.0
        c = coords - center.astype(np.float32)
        order = np.argsort(_morton_codes(c), kind="stable")
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)
        c = c[order]
        r_eff = radii[order] + np.float32(probe)

        cmin = c.min(axis=0)
        extent = float((c.max(axis=0) - cmin).max())
        if not extent <= MAX_Q_EXTENT:  # NaN-safe negation
            return None
        scale = np.float32(max(extent, 1e-6) / 65535.0)
        q = np.rint((c - cmin[None, :]) / scale)
        planes4[0:3, pos:pos + n] = np.clip(q, 0, 65535).astype(np.uint16).T
        qr = np.rint(r_eff * R_QUANT)
        if not float(qr.max(initial=0.0)) <= 65535.0:  # NaN-safe
            return None
        planes4[3, pos:pos + n] = np.maximum(qr, 1.0).astype(np.uint16)
        t0, t1 = tile0, tile0 + nt
        tparams[t0:t1, 0:3] = cmin
        tparams[t0:t1, 3] = scale
        tmeta[t0:t1, 0] = tile0
        tmeta[t0:t1, 1] = nt
        offsets.append((pos, n, inv))
        tile0 += nt
        pos += nt * ATOM_TILE
    return planes4, tparams, tmeta, offsets


def _morton_codes(coords: np.ndarray) -> np.ndarray:
    """30-bit Morton codes from quantized coordinates (10 bits/axis)."""
    q = coords - coords.min(axis=0, keepdims=True)
    scale = 1023.0 / max(float(q.max()), 1e-6)
    q = np.minimum((q * scale).astype(np.uint32), 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def quantize_packed(planes5: np.ndarray, spans: list) -> tuple:
    """Quantize f32 transfer planes -> (planes4 u16 [4,M], tparams [T,4]).

    spans: list of (pos, n) slot ranges, one per packed structure (padding
    slots between spans get qr=0).  Returns None if any structure's extent
    exceeds MAX_Q_EXTENT (caller falls back to the f32 path).

    The packers center coordinates per structure, so the box is symmetric
    and small; one uniform scale per structure keeps the grid isotropic.
    """
    m = planes5.shape[1]
    t = m // ATOM_TILE
    planes4 = np.zeros((4, m), dtype=np.uint16)
    tparams = np.zeros((t, 4), dtype=np.float32)
    tparams[:, 3] = 1.0  # neutral scale for unused tiles
    for pos, n in spans:
        if n == 0:
            continue
        sl = slice(pos, pos + n)
        c = planes5[0:3, sl]
        cmin = c.min(axis=1)
        extent = float((c.max(axis=1) - cmin).max())
        if not extent <= MAX_Q_EXTENT:  # NaN-safe negation
            return None
        scale = np.float32(max(extent, 1e-6) / 65535.0)
        q = np.rint((c - cmin[:, None]) / scale)
        planes4[0:3, sl] = np.clip(q, 0, 65535).astype(np.uint16)
        qr = np.rint(planes5[3, sl] * R_QUANT)
        if not float(qr.max(initial=0.0)) <= 65535.0:  # NaN-safe
            return None  # r_eff >= 8 A: exotic probe/radius, f32 path
        planes4[3, sl] = np.maximum(qr, 1.0).astype(np.uint16)
        t0, t1 = pos // ATOM_TILE, -(-(pos + n) // ATOM_TILE)
        tparams[t0:t1, 0:3] = cmin
        tparams[t0:t1, 3] = scale
    return planes4, tparams


def pack_structures(
    structures: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    probe: float,
    n_points: int,
):
    """Host-side packing for the fused kernel.

    structures: list of (coords [n,3] f32, radii [n] f32, gids [n] i32).
    Returns (planes [5, M], jlist [T, 128] u32 (mask<<16)|id, offsets,
    failed) where
    offsets[i] = (start, n, perm_inverse) for unpacking results and
    `failed` lists input indices whose tiling overflowed JLIST_CAP
    (callers route those through the list-based path); their offsets are
    None and their slots are zeroed.

    Dispatches to the native C++ packer (native/fastparse.cpp fastpack,
    same layout contract, parity-tested) when the library is available;
    this numpy implementation is the fallback and the executable spec.
    """
    from ..native import fastpack

    out = fastpack(structures, float(probe))
    if out is not None:
        return out
    return _pack_structures_numpy(structures, probe, n_points)


def _pack_structures_numpy(structures, probe, n_points):
    tiles_per = [-(-s[0].shape[0] // ATOM_TILE) for s in structures]
    total_tiles = sum(tiles_per)
    if total_tiles > 65535:
        raise ValueError(
            f"chunk too large for u16 tile ids: {total_tiles} tiles"
        )
    m = total_tiles * ATOM_TILE
    planes = np.zeros((N_XFER_PLANES, m), dtype=np.float32)
    jlist = np.zeros((total_tiles, JLIST_ROWS), dtype=np.uint32)

    offsets = []
    failed: list[int] = []
    tile0 = 0
    pos = 0
    for s_i, (coords, radii, gids) in enumerate(structures):
        n = coords.shape[0]
        nt = tiles_per[s_i]
        # Center per structure: |c| ~ 30 instead of ~300 keeps every f32
        # intermediate (|v|^2, dot chains) well away from cancellation.
        # Rounding the f64 mean to a 1/256 A grid makes the center - and
        # hence the whole packing - bit-identical to the native C++
        # packer, whose sequential f64 sum orders differently.
        center = np.round(
            coords.mean(axis=0, dtype=np.float64) * 256.0
        ) / 256.0
        coords = coords - center.astype(np.float32)
        order = np.argsort(_morton_codes(coords), kind="stable")
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)
        c = coords[order]
        r_eff = radii[order] + np.float32(probe)
        g = gids[order].astype(np.float64) + 1.0

        planes[0:3, pos:pos + n] = c.T
        planes[3, pos:pos + n] = r_eff
        planes[4, pos:pos + n] = g

        # Vectorized per-tile AND per-8-group AABBs + max reach; padding
        # slots are neutral.
        slots = nt * ATOM_TILE
        ng = nt * GROUPS_PER_TILE
        big = np.float32(3e4)
        cmin = np.full((slots, 3), big, dtype=np.float32)
        cmin[:n] = c
        cmax = np.full((slots, 3), -big, dtype=np.float32)
        cmax[:n] = c
        rpad = np.zeros(slots, dtype=np.float32)
        rpad[:n] = r_eff
        gmin = cmin.reshape(ng, J_GROUP, 3).min(axis=1)
        gmax = cmax.reshape(ng, J_GROUP, 3).max(axis=1)
        gmaxr = rpad.reshape(ng, J_GROUP).max(axis=1)
        tmin = gmin.reshape(nt, GROUPS_PER_TILE, 3).min(axis=1)
        tmax = gmax.reshape(nt, GROUPS_PER_TILE, 3).max(axis=1)
        tmaxr = gmaxr.reshape(nt, GROUPS_PER_TILE).max(axis=1)

        # Host-side tile-pair culling: [nt, nt] AABB separation test.
        gap = np.maximum(
            np.maximum(
                tmin[:, None, :] - tmax[None, :, :],
                tmin[None, :, :] - tmax[:, None, :],
            ),
            0.0,
        )
        sep2 = (gap * gap).sum(axis=2)
        # CULL_SLACK keeps the cull conservative under u16 coordinate
        # quantization (quantize_packed) - the kernel sees coordinates
        # moved by up to ~0.01 A relative to the f32 values culled here.
        reach = tmaxr[:, None] + tmaxr[None, :] + np.float32(CULL_SLACK)
        active = sep2 <= reach * reach  # [nt_i, nt_j]
        ii, jj = np.nonzero(active)
        masks = np.zeros(len(ii), dtype=np.uint32)
        if len(ii):
            # Fine culling: i-tile AABB vs each of the j-tile's 16 8-atom
            # group AABBs -> 16-bit mask per admitted pair.  The kernel
            # streams ONLY masked-in groups (the measured gap: ~2035
            # admitted j/atom at tile granularity vs ~875 at group
            # granularity).
            jg = (jj[:, None] * GROUPS_PER_TILE
                  + np.arange(GROUPS_PER_TILE)[None, :])  # [p, 16]
            ggap = np.maximum(
                np.maximum(
                    tmin[ii][:, None, :] - gmax[jg],
                    gmin[jg] - tmax[ii][:, None, :],
                ),
                0.0,
            )
            gsep2 = (ggap * ggap).sum(axis=2)  # [p, 16]
            greach = (tmaxr[ii][:, None] + gmaxr[jg]
                      + np.float32(CULL_SLACK))
            bits = gsep2 <= greach * greach  # [p, 16]
            masks = (
                bits.astype(np.uint32)
                << np.arange(GROUPS_PER_TILE, dtype=np.uint32)[None, :]
            ).sum(axis=1, dtype=np.uint32)
            # Pairs whose tile AABBs touch but no group does: drop.
            keep = masks != 0
            ii, jj, masks = ii[keep], jj[keep], masks[keep]
            pair_sep2 = sep2[ii, jj]
        counts = np.bincount(ii, minlength=nt)
        if counts.max(initial=0) > JLIST_CAP:
            # Pathological tiling (e.g. Morton folds spanning the box):
            # zero this structure's slots and let the caller reroute it.
            planes[:, pos:pos + n] = 0.0
            failed.append(s_i)
            offsets.append(None)
            tile0 += nt
            pos += nt * ATOM_TILE
            continue
        sl = slice(tile0, tile0 + nt)
        jlist[sl, 0] = counts
        if len(ii):
            # Deterministic nearest-first order within each row (by AABB
            # separation): keeps this packer bit-compatible with the
            # native C++ packer and the device-side banded builder, which
            # sort the same way.  (The shipped kernel streams branchlessly
            # - order does not affect its speed.)
            row_order = np.lexsort((pair_sep2, ii))
            ii = ii[row_order]
            jj = jj[row_order]
            masks = masks[row_order]
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            row_pos = np.arange(len(ii)) - np.repeat(starts, counts)
            jlist[tile0 + ii, 1 + row_pos] = (
                (masks << np.uint32(16)) | (jj + tile0).astype(np.uint32)
            )

        offsets.append((pos, n, inv))
        tile0 += nt
        pos += nt * ATOM_TILE

    return planes, jlist, offsets, failed


def to_device(wire, device) -> tuple:
    """Move a packer's numpy arrays to `device` as torch tensors.

    Unsigned wire words travel as the signed integer type of the same
    width (bit-preserving views: torch's unsigned types beyond uint8 have
    few kernels); the dequant stages widen and mask them back.  For a CUDA
    device each array is staged in pinned host memory, so the copy is
    asynchronous on the current stream.
    """
    device = torch.device(device)
    pinned = device.type == "cuda"
    signed = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16}
    out = []
    for a in wire:
        a = np.ascontiguousarray(a)
        if a.dtype in signed:
            a = a.view(signed[a.dtype])
        t = torch.from_numpy(a)
        if pinned:
            t = t.pin_memory()
        out.append(t.to(device, non_blocking=pinned))
    return tuple(out)


def _planes(q3, r_eff, qvalid, tparams):
    """[N_PLANES, M] f32 planes from quantized coordinates: q*scale+origin
    (multiply, then add), r_eff, and the slot index + 1 as the gid."""
    m = q3.shape[1]
    par = tparams.repeat_interleave(ATOM_TILE, dim=0)  # [M, 4]
    planes = torch.zeros((N_PLANES, m), dtype=torch.float32, device=q3.device)
    for axis in range(3):
        planes[axis] = q3[axis] * par[:, 3] + par[:, axis]
    planes[3] = r_eff
    slot_gid = torch.arange(m, dtype=torch.float32, device=q3.device) + 1.0
    planes[4] = torch.where(qvalid, slot_gid, 0.0)
    return planes


def dequant_q13_reference(wire_a, wire_b, palette, tparams):
    """q13 wire -> (planes [N_PLANES, M] f32, qvalid [M] bool), plain torch.

    Port of the dequant in the reference's fused_sasa_q13_banded.  The
    palette lookup is a gather, exact like the reference's select-sum.
    """
    wa = wire_a.to(torch.int64) & 0xFFFFFFFF
    wb = wire_b.to(torch.int64) & 0xFFFF
    q3 = torch.stack([
        wa & 0x1FFF,
        (wa >> 13) & 0x1FFF,
        (((wa >> 26) & 0x3F) << 7) | (wb & 0x7F),
    ]).to(torch.float32)
    ridx = (wb >> 7) & 0xFF
    qvalid = ridx > 0
    return _planes(q3, palette[ridx], qvalid, tparams), qvalid


def dequant_q16_reference(planes4, tparams):
    """q16 wire -> (planes [N_PLANES, M] f32, qvalid [M] bool), plain
    torch."""
    q = (planes4.to(torch.int64) & 0xFFFF).to(torch.float32)
    qvalid = q[3] > 0.0
    return _planes(q[0:3], q[3] * (1.0 / R_QUANT), qvalid, tparams), qvalid


Boxes = _kernels.Boxes


def tile_boxes_reference(planes, qvalid):
    """The banded cull's boxes of planes [>= 4, M] f32 -> Boxes: each
    tile's 8-atom groups' min / max corners and largest r_eff, and the
    tile's, padding slots at +3e4 / -3e4 and r_eff 0 (the reductions at
    the head of the reference's build_jlist_banded)."""
    m = planes.shape[1]
    t = m // ATOM_TILE
    ng = t * GROUPS_PER_TILE
    big = 3e4
    c = planes[0:3].T  # [M, 3]
    qv = qvalid[:, None]
    gmin = torch.where(qv, c, big).reshape(ng, J_GROUP, 3).amin(dim=1)
    gmax = torch.where(qv, c, -big).reshape(ng, J_GROUP, 3).amax(dim=1)
    gmaxr = torch.where(qvalid, planes[3], 0.0).reshape(ng, J_GROUP).amax(
        dim=1)
    gmin = gmin.reshape(t, GROUPS_PER_TILE, 3)
    gmax = gmax.reshape(t, GROUPS_PER_TILE, 3)
    gmaxr = gmaxr.reshape(t, GROUPS_PER_TILE)
    return Boxes(gmin, gmax, gmaxr, gmin.amin(dim=1), gmax.amax(dim=1),
                 gmaxr.amax(dim=1))


def _sum3(x):
    """Sum over a trailing axis of 3 in the reference's order."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def band_boxes(planes, qvalid, tmeta, *, w: int, boxes=None):
    """The banded cull's tile-pair stage and the fine stage's inputs.

    For the nd = 2w-1 offsets d in (-w, w) of every i-tile's own tile
    band, returns
      j [nd, T] i64: the j-tile i + d - (w-1),
      act [nd, T] bool: the tile pair is in the structure and its AABBs
        are in reach,
      sep2 [nd, T] f32: the tile pair's squared AABB separation,
      c_t [T, 128, 3], r_t [T, 128]: each i-atom's point (far away for
        padding) and r_eff (0 for padding),
      group boxes (gmin, gmax [T + 2(w-1), 16, 3], gmaxr [T + 2(w-1), 16]):
        every tile's 8-atom-group boxes and largest r_eff, zero-padded by
        w-1 tiles on both sides, so offset d's j-tiles are rows d:d+T.
    `boxes` (Boxes) are the planes' own, reduced here when None.
    """
    m = planes.shape[1]
    t = m // ATOM_TILE
    dev = planes.device
    big = 3e4
    c = planes[0:3].T  # [M, 3]
    qv = qvalid[:, None]
    gmin, gmax, gmaxr, tmin, tmax, tmaxr = (
        tile_boxes_reference(planes, qvalid) if boxes is None else boxes)

    start = tmeta[:, 0]
    end = start + tmeta[:, 1]
    nd = 2 * w - 1

    def padded(x):
        """Zero-pad the tile axis by w-1 on both sides: the window of
        offset index d is padded(x)[d:d + t], holding x[i + d - (w-1)]."""
        z = torch.zeros((w - 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=dev)
        return torch.cat([z, x, z])

    def shifted(x):
        xp = padded(x)
        return torch.stack([xp[d:d + t] for d in range(nd)])

    offs = torch.arange(-(w - 1), w, dtype=torch.int64, device=dev)
    j = torch.arange(t, dtype=torch.int64, device=dev)[None, :] + offs[:, None]
    valid = (j >= start[None, :]) & (j < end[None, :])  # [nd, T]

    gap = torch.clamp_min(
        torch.maximum(tmin[None] - shifted(tmax), shifted(tmin) - tmax[None]),
        0.0,
    )
    sep2 = _sum3(gap * gap)  # [nd, T]
    reach = tmaxr[None] + shifted(tmaxr) + DEVICE_CULL_SLACK
    act = valid & (sep2 <= reach * reach)
    c_t = torch.where(qv, c, big).reshape(t, ATOM_TILE, 3)
    r_t = torch.where(qvalid, planes[3], 0.0).reshape(t, ATOM_TILE)
    return j, act, sep2, c_t, r_t, (padded(gmin), padded(gmax),
                                    padded(gmaxr))


def band_cull(planes, qvalid, tmeta, *, w: int, halves: int = 1,
              boxes=None):
    """The banded cull shared by the device-side j-list builders.

    Returns band_boxes' j, act and sep2 [nd, T] and
      bits [nd, T, GROUPS_PER_TILE, halves] bool: some i-atom (point plus
        its own r_eff) of the i-tile's half h reaches the box of j-tile
        group g (halves=1: of the whole tile, halves=2: of lanes 0-63
        and 64-127).
    """
    j, act, sep2, c_t, r_t, (gmin_p, gmax_p, gmaxr_p) = band_boxes(
        planes, qvalid, tmeta, w=w, boxes=boxes)
    nd, t = act.shape
    # Fine granularity: every i-atom (point + its own r_eff) against the
    # j-tile's 16 8-atom-group boxes, one offset d at a time.
    bits = torch.empty((nd, t, GROUPS_PER_TILE, halves), dtype=torch.bool,
                       device=planes.device)
    for d in range(nd):
        mn = gmin_p[d:d + t, :, None, :]  # [T, 16, 1, 3]
        mx = gmax_p[d:d + t, :, None, :]
        ci = c_t[:, None, :, :]  # [T, 1, A, 3]
        g = torch.clamp_min(torch.maximum(mn - ci, ci - mx), 0.0)
        pb2 = _sum3(g * g)  # [T, 16, A]
        rr = r_t[:, None, :] + gmaxr_p[d:d + t, :, None] + DEVICE_CULL_SLACK
        bits[d] = (rr * rr - pb2).reshape(
            t, GROUPS_PER_TILE, halves, ATOM_TILE // halves
        ).amax(dim=-1) >= 0.0
    return j, act, sep2, bits


def group_mask(bits):
    """[..., GROUPS_PER_TILE] bool -> [...] i64 16-bit group masks."""
    weights = 1 << torch.arange(GROUPS_PER_TILE, dtype=torch.int64,
                                device=bits.device)
    return (bits.to(torch.int64) * weights).sum(dim=-1)


def compact_rows(act, sep2, *payloads):
    """Nearest-first compaction of band entries into [T, JLIST_ROWS] i32
    rows, one per [nd, T] i64 payload: a stable sort of each band row by
    masked separation (inactive entries sink to the end with +inf keys),
    the payloads gathered in that order and narrowed to int32, so bit 31
    wraps negative exactly as the reference's int32 shifts do.  Column 0
    of the first row holds the count of active entries, of the others 0.
    """
    nd, t = act.shape
    key = torch.where(act, sep2, float("inf")).T  # [T, nd]
    _, order = torch.sort(key, dim=1, stable=True)
    nkeep = min(nd, JLIST_CAP)
    rows = []
    for payload in payloads:
        sorted_ = payload.T.gather(1, order).to(torch.int32)
        row = torch.zeros((t, JLIST_ROWS), dtype=torch.int32, device=act.device)
        row[:, 1:1 + nkeep] = sorted_[:, :nkeep]
        rows.append(row)
    rows[0][:, 0] = act.sum(dim=0).to(torch.int32)
    return rows


def build_jlist_banded_reference(planes, qvalid, tmeta, *, w: int,
                                 boxes=None):
    """Tile-pair culling on the device -> [T, JLIST_ROWS] i32 j-lists,
    plain torch.

    Port of the reference's build_jlist_banded, byte-equal to it: banded
    tile-pair AABB test over offsets d in (-w, w) within each structure's
    own tile band, per-i-atom point-to-box 8-atom-group masks, and a
    stable nearest-first sort.  Entries are built in int64 and narrowed,
    so a mask with bit 15 set wraps negative exactly as the reference's
    int32 shift does.  `boxes` as in band_boxes.
    """
    j, act, sep2, bits = band_cull(planes, qvalid, tmeta, w=w, boxes=boxes)
    mask = group_mask(bits[..., 0])  # [nd, T]
    act = act & (mask > 0)
    return compact_rows(act, sep2, (mask << 16) | j)[0]


def admitted_atoms(ent, live):
    """The j-atom slots admitted by j-list entries ent [B, CAP] i64
    ((mask << 16) | j_tile; live [B, CAP] bool) -> (jidx, jv), both
    [B, n_j]: each row's admitted slots first, in entry and group order,
    then padding (slot 0, jv False); n_j >= 1."""
    b = ent.shape[0]
    dev = ent.device
    garange = torch.arange(GROUPS_PER_TILE, device=dev)
    ratom = torch.arange(J_GROUP, device=dev)
    gbit = (((ent[:, :, None] >> 16) >> garange) & 1).bool()
    gbit = gbit & live[:, :, None]  # [B, CAP, 16]
    atom = ((ent & 0xFFFF)[:, :, None, None] * ATOM_TILE
            + garange[:, None] * J_GROUP + ratom)  # [B, CAP, 16, 8]
    ok = gbit[..., None].expand_as(atom).reshape(b, -1)
    atom = atom.reshape(b, -1)
    order = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)
    n_j = max(int(ok.sum(dim=1).max()), 1)
    jv = ok.gather(1, order[:, :n_j])
    return torch.where(jv, atom.gather(1, order[:, :n_j]), 0), jv


def fused_counts_reference(planes, jlist, sphere):
    """Plain-torch occlusion counts: [N_PLANES, M] planes -> [M] i32.

    For every i-atom and sphere point, the max over the admitted j-atoms
    (j-list entries and their 8-atom group masks) of lim - dot, with
      v = c_i - c_j,  v2 = (vx*vx + vy*vy) + vz*vz,
      lim = ((r_j*r_j - v2) - r_i*r_i) * (0.5 / max(r_i, 1e-6)),
      dot = sx*vx + (sy*vy + sz*vz),
    lim = -1e30 where gid_j == gid_i or gid_j == 0; a point counts as
    accessible when that max is <= 0 and the point is valid.  The
    reference computes the same in `_fused_count_kernel`.  Work is done
    in blocks of at most REFERENCE_BLOCK_ELEMS[device] (j, i, point) margins.
    """
    m = planes.shape[1]
    t = m // ATOM_TILE
    dev = planes.device
    p = sphere.shape[0]
    sx, sy, sz = sphere[:, 0], sphere[:, 1], sphere[:, 2]
    point_valid = sphere[:, 3] > 0.0
    out = torch.empty(m, dtype=torch.int32, device=dev)
    block_elems = REFERENCE_BLOCK_ELEMS[dev.type]

    ent = jlist[:, 1:].to(torch.int64) & 0xFFFFFFFF  # [T, JLIST_CAP]
    live = (torch.arange(JLIST_CAP, device=dev)[None, :]
            < jlist[:, 0:1].to(torch.int64))
    tiles_per_block = max(1, min(t, 64))
    for t0 in range(0, t, tiles_per_block):
        t1 = min(t, t0 + tiles_per_block)
        b = t1 - t0
        jidx, jv = admitted_atoms(ent[t0:t1], live[t0:t1])
        n_j = jidx.shape[1]
        xk, yk, zk, rk, gk = (planes[row][jidx] for row in range(5))

        sl = slice(t0 * ATOM_TILE, t1 * ATOM_TILE)
        xi, yi, zi, ri, gi = (
            planes[row, sl].reshape(b, 1, ATOM_TILE) for row in range(5)
        )
        r2i = ri * ri
        # Tensor / tensor: `0.5 / x` would run as reciprocal(x) * 0.5.
        inv2ri = torch.full_like(ri, 0.5) / torch.clamp_min(ri, 1e-6)
        occ = torch.full((b, ATOM_TILE, p), _NEG_BIG, dtype=torch.float32,
                         device=dev)
        jc = max(1, block_elems // (b * ATOM_TILE * p))
        for j0 in range(0, n_j, jc):
            js = slice(j0, j0 + jc)
            vx = xi - xk[:, js, None]  # [B, Jc, A]
            vy = yi - yk[:, js, None]
            vz = zi - zk[:, js, None]
            v2 = (vx * vx + vy * vy) + vz * vz
            rkk = rk[:, js, None]
            lim = ((rkk * rkk - v2) - r2i) * inv2ri
            gkk = gk[:, js, None]
            lim = torch.where(
                (gkk == gi) | (gkk == 0.0) | ~jv[:, js, None], _NEG_BIG, lim
            )
            vx, vy, vz, lim = (a[..., None] for a in (vx, vy, vz, lim))
            dots = sx * vx + (sy * vy + sz * vz)  # [B, Jc, A, P]
            occ = torch.maximum(occ, (lim - dots).amax(dim=1))
        acc = (occ <= 0.0) & point_valid
        out[sl] = acc.sum(dim=-1, dtype=torch.int32).reshape(-1)
    return out


def _tile_blocks(planes, jlist):
    """Blocks of at most 64 i-tiles, as (tile slice, slot slice, the
    admitted j-atoms (jidx, jv) of admitted_atoms, the i-atoms' planes
    (x, y, z, r_eff, gid) each [B, 1, ATOM_TILE])."""
    m = planes.shape[1]
    t = m // ATOM_TILE
    dev = planes.device
    ent = jlist[:, 1:].to(torch.int64) & 0xFFFFFFFF  # [T, JLIST_CAP]
    live = (torch.arange(JLIST_CAP, device=dev)[None, :]
            < jlist[:, 0:1].to(torch.int64))
    tiles_per_block = max(1, min(t, 64))
    for t0 in range(0, t, tiles_per_block):
        t1 = min(t, t0 + tiles_per_block)
        sl = slice(t0 * ATOM_TILE, t1 * ATOM_TILE)
        yield (slice(t0, t1), sl, *admitted_atoms(ent[t0:t1], live[t0:t1]),
               tuple(planes[row, sl].reshape(t1 - t0, 1, ATOM_TILE)
                     for row in range(5)))


def _j_chunks(n_j, b, p, dev):
    """Slices of at most REFERENCE_BLOCK_ELEMS[device] / (b x 128 x p)
    admitted j-atoms."""
    jc = max(1, REFERENCE_BLOCK_ELEMS[dev.type] // (b * ATOM_TILE * p))
    return [slice(j0, j0 + jc) for j0 in range(0, n_j, jc)]


# The reach skip of csrc/fused_count.cu (count_tile.cuh kReachSlack,
# kUnitNorm2, kRadiusRatio), as f32 tensors so every comparison and
# product rounds in f32 as the kernel's do.
REACH_SLACK = torch.tensor(1.0 + 2.0 ** -14, dtype=torch.float32)
# keep_row's slack for margins computed in bf16 (count_tile.cuh
# kBf16Slack: v2 > 1.25^2 (r_i + r_j)^2), reach_count.cu's bf16 variants.
BF16_SLACK = torch.tensor(1.5625, dtype=torch.float32)
UNIT_NORM2 = torch.tensor(1.0 + 2.0 ** -20, dtype=torch.float32)
RADIUS_RATIO = torch.tensor(8.0, dtype=torch.float32)
_MIN_R = torch.tensor(1e-6, dtype=torch.float32)
# Consecutive i-atoms a warp of the count kernel holds (32 lanes,
# COUNT_LANES an atom); the warp streams the union of their rows.
WARP_ATOMS = 32 // _kernels.COUNT_LANES


def sphere_far_ok(sphere) -> bool:
    """Whether every valid point of sphere [P, 4] has (sx*sx + sy*sy) +
    sz*sz <= UNIT_NORM2 in f32, so the kernel may skip rows by distance."""
    s = sphere[sphere[:, 3] > 0.0]
    n2 = (s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1]) + s[:, 2] * s[:, 2]
    return bool((n2 <= UNIT_NORM2.to(sphere.device)).all())


def reach_far(v2, ri, rj, slack=REACH_SLACK):
    """The distance part of the kernel's keep_pair on broadcastable f32
    tensors (v2 as fused_counts_reference rounds it) -> bool: v2 > (r_i +
    r_j)^2 * slack (REACH_SLACK, or BF16_SLACK for keep_row's bf16 form),
    r_i >= 1e-6 and RADIUS_RATIO * r_j >= r_i."""
    dev = v2.device
    reach = ri + rj
    return ((v2 > (reach * reach) * slack.to(dev))
            & (ri >= _MIN_R.to(dev)) & (rj * RADIUS_RATIO.to(dev) >= ri))


def reach_keep(v2, ri, rj, gi, gj, far_ok: bool):
    """The kernel's keep_pair -> bool: false where gid_i == 0, gid_j == 0
    or gid_j == gid_i, and, where far_ok, where reach_far."""
    drop = (gi == 0.0) | (gj == 0.0) | (gj == gi)
    return ~(drop | (reach_far(v2, ri, rj) & far_ok))


# keep_row's distance skip for an i-atom with r_i < 1e-6 (count_tile.cuh
# kTinyReach2): v2 >= 2 r_j^2 and v2 >= TINY_REACH2.
TINY_REACH2 = torch.tensor(2.0 ** -30, dtype=torch.float32)


def reach_keep_row(v2, ri, rj, gi, gj, far_ok: bool, slack=REACH_SLACK):
    """keep_row of the studies on kernel 1's layout (csrc/count_tile.cuh)
    -> bool: false where gid_j == 0 or gid_j == gid_i, and, where far_ok,
    where reach_far(v2, ri, rj, slack) (r_i >= 1e-6) or, for r_i < 1e-6
    (padding), v2 >= 2 r_j^2 and v2 >= TINY_REACH2.  Unlike reach_keep, an
    i-atom of gid 0 keeps its rows, so every count stays the reference's.
    BF16_SLACK gives the form for margins computed in bf16."""
    dev = v2.device
    tiny_far = (v2 >= 2.0 * (rj * rj)) & (v2 >= TINY_REACH2.to(dev))
    far = torch.where(ri >= _MIN_R.to(dev), reach_far(v2, ri, rj, slack),
                      tiny_far)
    return ~((gj == 0.0) | (gj == gi) | (far & far_ok))


def _warp_any(keep):
    """keep [..., ATOM_TILE] ORed over each warp's WARP_ATOMS atoms and
    broadcast back to them."""
    shape = keep.shape
    return (keep.reshape(*shape[:-1], ATOM_TILE // WARP_ATOMS, WARP_ATOMS)
            .any(dim=-1).repeat_interleave(WARP_ATOMS, dim=-1))


def fused_counts_kept_reference(planes, jlist, sphere):
    """fused_counts_reference with only the j-rows the count kernel
    streams: for each warp of WARP_ATOMS consecutive atoms of a tile, the
    admitted rows that some atom of the warp keeps (reach_keep); an atom's
    lim is -1e30 at a streamed row it does not keep, and a row its warp
    does not stream leaves its max.  The plain model of the kernel's skip:
    byte-equal to fused_counts_reference at real slots when the skip is
    right."""
    m = planes.shape[1]
    dev = planes.device
    p = sphere.shape[0]
    sx, sy, sz = sphere[:, 0], sphere[:, 1], sphere[:, 2]
    point_valid = sphere[:, 3] > 0.0
    far_ok = sphere_far_ok(sphere)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    for _ts, sl, jidx, jv, (xi, yi, zi, ri, gi) in _tile_blocks(planes,
                                                                 jlist):
        b = jidx.shape[0]
        xk, yk, zk, rk, gk = (planes[row][jidx] for row in range(5))
        r2i = ri * ri
        inv2ri = torch.full_like(ri, 0.5) / torch.clamp_min(ri, 1e-6)
        occ = torch.full((b, ATOM_TILE, p), _NEG_BIG, dtype=torch.float32,
                         device=dev)
        for js in _j_chunks(jidx.shape[1], b, p, dev):
            vx = xi - xk[:, js, None]  # [B, Jc, A]
            vy = yi - yk[:, js, None]
            vz = zi - zk[:, js, None]
            v2 = (vx * vx + vy * vy) + vz * vz
            rkk = rk[:, js, None]
            lim = ((rkk * rkk - v2) - r2i) * inv2ri
            keep = (reach_keep(v2, ri, rkk, gi, gk[:, js, None], far_ok)
                    & jv[:, js, None])
            streamed = _warp_any(keep)
            lim = torch.where(keep, lim, _NEG_BIG)
            vx, vy, vz, lim = (a[..., None] for a in (vx, vy, vz, lim))
            margins = lim - (sx * vx + (sy * vy + sz * vz))  # [B, Jc, A, P]
            margins = torch.where(streamed[..., None], margins,
                                  float("-inf"))
            occ = torch.maximum(occ, margins.amax(dim=1))
        acc = (occ <= 0.0) & point_valid
        out[sl] = acc.sum(dim=-1, dtype=torch.int32).reshape(-1)
    return out


# Group sizes of reach_work's "in reach of some atom of" columns: the
# tile, a warp of 32 atoms, 4 consecutive atoms, the atom itself.
REACH_GROUPS = (ATOM_TILE, 32, 4, 1)
# FP32 instructions of one margin (3 mul, 2 add, 1 sub, 1 max), and of
# the reach test for one (i-atom, j-row) pair as its arithmetic needs it:
# v2 (3 sub, 3 mul, 2 add), (r_i + r_j)^2 (1 add, 1 mul), the slack (1
# mul), the compare (1), and the gid tests gid_j != gid_i, gid_j != 0 (2).
# The kernel's own SASS spends REACH_INSTR_SASS, the radius guards, 8 r_j
# and the padding test on top (6 FADD, 6 FMUL and 5 FSETP a pair: 35 in
# the block before the vote of fused_count_kernel<7, false>, 17 for each
# of a warp's 2 atoms and 1 for the row's own gid_j == 0 test;
# scripts/sass_mix.py --before VOTE.ANY): a cross-check, not the
# yardstick.
INSTR_PER_MARGIN = 7
REACH_INSTR_PER_PAIR = 14
REACH_INSTR_SASS = 17


def needed_instructions(work: dict, n_points: int,
                        per_pair: int = REACH_INSTR_PER_PAIR) -> int:
    """FP32 instructions the counts of reach_work's inputs need: a margin
    at each of n_points points for each pair in reach, and a reach test
    of `per_pair` instructions for each admitted pair (chip_smoke.py's
    bound of kernel 1)."""
    return (INSTR_PER_MARGIN * n_points * work["reach"][1]
            + per_pair * work["admitted"])


def reach_work(planes, jlist, sphere) -> dict:
    """The count kernel's work on these inputs, summed over the real
    i-atoms (gid != 0), plain torch -> {"atoms", "admitted", "reach":
    {group size: pairs}, "far", "kept", "warp_rows"}.

    "admitted" counts the (i, j) pairs of the admitted j-atoms;
    "reach"[G] the admitted pairs whose j-atom is in reach of some real
    atom of i's aligned group of G atoms (REACH_GROUPS): v2 < (r_i +
    r_j)^2 in f32, gid_j not gid_i nor 0.  "reach"[1] is the pairs in
    reach.  "far" counts the admitted pairs whose gids keep them but the
    kernel's distance test skips (reach_far, where the sphere allows it).
    "kept" counts the pairs of the rows each warp streams (reach_keep
    ORed over its WARP_ATOMS atoms), and "warp_rows" [T, ATOM_TILE /
    WARP_ATOMS] i64 those rows by warp, for one point pass.
    """
    dev = planes.device
    t = planes.shape[1] // ATOM_TILE
    far_ok = sphere_far_ok(sphere)
    out = {"atoms": 0, "admitted": 0, "reach": dict.fromkeys(REACH_GROUPS, 0),
           "far": 0, "kept": 0,
           "warp_rows": torch.zeros((t, ATOM_TILE // WARP_ATOMS),
                                    dtype=torch.int64, device=dev)}
    for ts, _sl, jidx, jv, (xi, yi, zi, ri, gi) in _tile_blocks(planes,
                                                                jlist):
        b = jidx.shape[0]
        xk, yk, zk, rk, gk = (planes[row][jidx] for row in range(5))
        real = gi != 0.0  # [B, 1, A]

        def per_group(hit, g):
            """Pairs of real atoms whose group of g has a hit, and the
            rows each group hits [B, A / g]."""
            rows = hit.reshape(b, -1, ATOM_TILE // g, g).any(dim=-1)
            n_real = real.reshape(b, 1, ATOM_TILE // g, g).sum(dim=-1)
            return int((rows * n_real).sum()), rows.sum(dim=1)

        out["atoms"] += int(real.sum())
        out["admitted"] += int((jv.sum(dim=1) * real.sum(dim=(1, 2))).sum())
        for js in _j_chunks(jidx.shape[1], b, 1, dev):
            vx = xi - xk[:, js, None]
            vy = yi - yk[:, js, None]
            vz = zi - zk[:, js, None]
            v2 = (vx * vx + vy * vy) + vz * vz
            rkk = rk[:, js, None]
            gkk = gk[:, js, None]
            near = (gkk != gi) & (gkk != 0.0) & real & jv[:, js, None]
            reach = ri + rkk
            hit = (v2 < reach * reach) & near
            for g in REACH_GROUPS:
                out["reach"][g] += per_group(hit, g)[0]
            if far_ok:
                out["far"] += int((near & reach_far(v2, ri, rkk)).sum())
            keep = reach_keep(v2, ri, rkk, gi, gkk, far_ok) & jv[:, js, None]
            pairs, rows = per_group(keep, WARP_ATOMS)
            out["kept"] += pairs
            out["warp_rows"][ts] += rows
    return out


def on_device(plain, kernel, planes, *args, **kwargs):
    """`plain(planes, ...)` for CPU tensors, the hand-written `kernel` for
    CUDA tensors; the kernel launches or raises and never falls back, and
    any other device is refused."""
    if planes.device.type == "cpu":
        return plain(planes, *args, **kwargs)
    if planes.device.type != "cuda":
        raise ValueError(f"{kernel.__name__}: unsupported device {planes.device}")
    return kernel(planes, *args, **kwargs)


def _with_boxes(dequant):
    """A plain dequant that also returns tile_boxes_reference's boxes."""
    def plain(*wire):
        planes, qvalid = dequant(*wire)
        return planes, qvalid, tile_boxes_reference(planes, qvalid)
    return plain


def _planes_only(launcher):
    """A dequant_boxes launcher that writes no boxes -> (planes, qvalid)."""
    def kernel(*wire):
        return launcher(*wire, boxes=False)[:2]
    kernel.__name__ = launcher.__name__
    return kernel


def dequant_boxes_q13(wire_a, wire_b, palette, tparams):
    """q13 wire -> (planes [N_PLANES, M] f32, qvalid [M] bool, Boxes).

    CUDA tensors launch `dequant_boxes` (or raise); CPU tensors take
    dequant_q13_reference and tile_boxes_reference.
    """
    return on_device(_with_boxes(dequant_q13_reference), _kernels.dequant_q13,
                     wire_a, wire_b, palette, tparams)


def dequant_boxes_q16(planes4, tparams):
    """q16 wire -> (planes [N_PLANES, M] f32, qvalid [M] bool, Boxes), as
    dequant_boxes_q13."""
    return on_device(_with_boxes(dequant_q16_reference), _kernels.dequant_q16,
                     planes4, tparams)


def dequant_q13(wire_a, wire_b, palette, tparams):
    """q13 wire -> (planes [N_PLANES, M] f32, qvalid [M] bool): the
    `dequant_boxes` kernel on CUDA, writing no boxes, the plain version
    on the CPU."""
    return on_device(dequant_q13_reference, _planes_only(_kernels.dequant_q13),
                     wire_a, wire_b, palette, tparams)


def dequant_q16(planes4, tparams):
    """q16 wire -> (planes [N_PLANES, M] f32, qvalid [M] bool), as
    dequant_q13."""
    return on_device(dequant_q16_reference, _planes_only(_kernels.dequant_q16),
                     planes4, tparams)


def _band_jlist(planes, qvalid, tmeta, *, w: int, boxes=None):
    if boxes is None:
        boxes = _kernels.tile_boxes(planes, qvalid)
    return _kernels.band_jlist(planes, qvalid, tmeta, boxes, w)


def build_jlist_banded(planes, qvalid, tmeta, *, w: int, boxes=None):
    """Banded cull -> [T, JLIST_ROWS] i32 j-lists, byte-equal to
    build_jlist_banded_reference.

    planes [>= 4, M] f32, qvalid [M] bool, tmeta [T, 2] i32 and, where
    the dequant made them, the planes' Boxes.  CUDA tensors launch
    `band_jlist` (after `dequant_boxes` when boxes is None) or raise; CPU
    tensors take the plain version.
    """
    return on_device(build_jlist_banded_reference, _band_jlist, planes,
                     qvalid, tmeta, w=w, boxes=boxes)


def fused_counts(planes, jlist, sphere):
    """Occlusion counts [M] i32 from planes [>= 5, M] f32 (rows x, y, z,
    r_eff, gid+1; later rows are not read), j-lists [T, JLIST_ROWS] i32
    and the sphere [P, 4] f32 (x, y, z, valid).

    CPU tensors take the plain-torch version; CUDA tensors launch the
    hand-written kernel (or raise) and never fall back.
    """
    return on_device(fused_counts_reference, _kernels.fused_count, planes,
                     jlist, sphere)


def _counts_out(counts, n_points: int):
    """Readback dtype of the reference: u8 when n_points <= 255, else u16
    (carried as the same-width int16; counts <= MAX_P_PAD fit)."""
    return counts.to(torch.uint8 if n_points <= 255 else torch.int16)


def _no_mark(stage: str) -> None:
    pass


def fused_sasa_q13_banded(wire_a, wire_b, palette, tparams, tmeta, sphere,
                          *, n_points: int, w: int, mark=_no_mark):
    """6 B/slot wire + device-side culling -> per-slot occlusion counts:
    on CUDA the dequant_boxes, band_jlist and fused_count kernels, one
    launch each.  `mark(stage)` is called after each of the three is
    queued (scripts/r3_split.py records a CUDA event there)."""
    planes, qvalid, boxes = dequant_boxes_q13(wire_a, wire_b, palette,
                                              tparams)
    mark("dequant_boxes")
    jlist = build_jlist_banded(planes, qvalid, tmeta, w=w, boxes=boxes)
    mark("band_jlist")
    out = _counts_out(fused_counts(planes, jlist, sphere), n_points)
    mark("fused_count")
    return out


def fused_sasa_q16_banded(planes4, tparams, tmeta, sphere,
                          *, n_points: int, w: int):
    """8 B/slot wire + device-side culling -> per-slot occlusion counts,
    as fused_sasa_q13_banded."""
    planes, qvalid, boxes = dequant_boxes_q16(planes4, tparams)
    jlist = build_jlist_banded(planes, qvalid, tmeta, w=w, boxes=boxes)
    return _counts_out(fused_counts(planes, jlist, sphere), n_points)


def fused_sasa_q16(planes4, tparams, jlist, sphere, *, n_points: int):
    """Host-cull q16 wire: 8 B/slot planes culled on the host
    (pack_structures + quantize_packed) -> per-slot occlusion counts.

    Dequantized with per-tile params and slot-index gids exactly like the
    banded q16 wire; the j-list rides with the planes.
    """
    planes, _qvalid = dequant_q16(planes4, tparams)
    return _counts_out(fused_counts(planes, jlist, sphere), n_points)


def fused_sasa(planes5, jlist, sphere, *, n_points: int):
    """f32 host-cull wire with real group ids -> per-slot SASA [M] f32.

    planes5: [N_XFER_PLANES, M] f32 (x, y, z, r_eff, gid+1; 0 = padding).
    SASA = counts * (4 pi / n_points * r_eff) * r_eff, in the reference's
    order; the reference reads back f16 by default for its TPU link, the
    port reads back f32.
    """
    r_eff = planes5[3]
    area = torch.where(
        planes5[4] > 0.0,
        (r_eff * float(np.float32(4.0 * np.pi / n_points))) * r_eff,
        0.0,
    )
    counts = fused_counts(planes5, jlist, sphere)
    return counts.to(torch.float32) * area
