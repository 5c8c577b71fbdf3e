"""Tile-level occlusion-saturation skip, on the card.

Port of the round-4 count-kernel study `scripts/r4_saturation.py`:

    python -m rustsasa_tpu_torch.scripts.r4_saturation [corpus_dir]

packs one host-cull f32 chunk (pack_structures: real group ids, j-lists
culled on the host) of up to 2,097,152 slots and times kernel 1 (prod)
against csrc/saturation_count.cu checking every 1, 2 and 4 entries
(sat1, sat2, sat4: the script's tilesat_vmem, sat2 and sat4).  Once all
points of a pass are occluded for all 128 atoms of a tile, the tile's
remaining entries can only re-occlude occluded points, so the counts
must equal prod's exactly.  Per variant it reports milliseconds,
Matoms/s, the largest count difference to prod at real slots and the
share of j-list entries skipped.  Without a corpus directory the
repository's FreeSASA test structures are cycled.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import _kernels, engine
from ..ops import fused_kernel as fk
from ..ops.fused_kernel import (
    ATOM_TILE, J_GROUP, JLIST_CAP, JLIST_ROWS, REFERENCE_BLOCK_ELEMS, _NEG_BIG,
)
from . import _study

CHECKS = (1, 2, 4)


def saturation_counts_reference(planes, jlist, sphere, *, check_every: int):
    """Plain-torch version of saturation_counts -> (counts [M] i32,
    streamed [T] i32).

    Entry by entry, every tile's running max margins over its admitted
    j-atoms (kernel 1's arithmetic; valid points start at -1e30, pad
    points at +1); after entry e with e % check_every == check_every - 1,
    each point pass of the kernel's split (_kernels.point_passes) whose
    margins are all > 0 over the tile's 128 atoms stops there.  The
    margins keep being taken after a pass stops: they can only grow, so
    the counts are those of the kernel, which skips them, and of
    fused_counts_reference.  Work is done in blocks of at most
    REFERENCE_BLOCK_ELEMS[device] (j, i, point) margins.
    """
    if check_every < 1:
        raise ValueError(f"check_every {check_every} < 1")
    m = planes.shape[1]
    t = m // ATOM_TILE
    dev = planes.device
    passes, k = _kernels.point_passes(sphere.shape[0])
    n_cover = passes * _kernels.SLICES * k
    pts = torch.zeros((n_cover, 4), dtype=torch.float32, device=dev)
    pts[:sphere.shape[0]] = sphere
    sx, sy, sz = pts[:, 0], pts[:, 1], pts[:, 2]
    point_valid = pts[:, 3] > 0.0
    init = torch.where(point_valid, _NEG_BIG, 1.0)

    n_ent = jlist[:, 0].to(torch.int64).clamp(0, JLIST_CAP)
    ent = jlist[:, 1:].to(torch.int64) & 0xFFFFFFFF
    jtile = ent & 0xFFFF
    masks = ent >> 16
    counts = torch.empty(m, dtype=torch.int32, device=dev)
    streamed = torch.empty(t, dtype=torch.int32, device=dev)
    lane = torch.arange(ATOM_TILE, device=dev)
    block = max(1, REFERENCE_BLOCK_ELEMS[dev.type]
                // (ATOM_TILE * ATOM_TILE * n_cover))
    for t0 in range(0, t, block):
        t1 = min(t, t0 + block)
        b = t1 - t0
        sl = slice(t0 * ATOM_TILE, t1 * ATOM_TILE)
        xi, yi, zi, ri, gi = (
            planes[row, sl].reshape(b, 1, ATOM_TILE) for row in range(5)
        )
        r2i = ri * ri
        # Tensor / tensor: `0.5 / x` would run as reciprocal(x) * 0.5.
        inv2ri = torch.full_like(ri, 0.5) / torch.clamp_min(ri, 1e-6)
        occ = init.expand(b, ATOM_TILE, n_cover).clone()
        n_b = n_ent[t0:t1]
        stop = n_b[:, None].expand(b, passes).clone()
        done = torch.zeros((b, passes), dtype=torch.bool, device=dev)
        for e in range(int(n_b.max()) if b else 0):
            live = e < n_b
            jt = jtile[t0:t1, e]
            mask = masks[t0:t1, e]
            admit = live & (jt < t) & (mask != 0)  # [B]
            if bool(admit.any()):
                atom = torch.where(admit, jt, 0)[:, None] * ATOM_TILE + lane
                ok = (((mask[:, None] >> (lane // J_GROUP)) & 1).bool()
                      & admit[:, None])  # [B, J]
                xk, yk, zk, rk, gk = (
                    planes[row][atom][:, :, None] for row in range(5)
                )  # [B, J, 1]
                vx = xi - xk  # [B, J, A]
                vy = yi - yk
                vz = zi - zk
                v2 = (vx * vx + vy * vy) + vz * vz
                lim = ((rk * rk - v2) - r2i) * inv2ri
                lim = torch.where(
                    (gk == gi) | (gk == 0.0) | ~ok[:, :, None], _NEG_BIG, lim
                )
                vx, vy, vz, lim = (a[..., None] for a in (vx, vy, vz, lim))
                dots = sx * vx + (sy * vy + sz * vz)  # [B, J, A, P]
                occ = torch.maximum(occ, (lim - dots).amax(dim=1))
            if e % check_every == check_every - 1:
                sat = (occ.reshape(b, ATOM_TILE, passes, -1) > 0.0).all(
                    dim=3).all(dim=1)  # [B, passes]
                newly = sat & ~done & live[:, None]
                stop = torch.where(newly, e + 1, stop)
                done |= newly
        acc = (occ <= 0.0) & point_valid
        counts[sl] = acc.sum(dim=-1, dtype=torch.int32).reshape(-1)
        streamed[t0:t1] = stop.sum(dim=1).to(torch.int32)
    return counts, streamed


def buried_block_wire(repeats: int = 4):
    """(planes [5, 384] f32, jlist [3, JLIST_ROWS] u32): a host-cull wire
    on which the skip fires.  Tile 0 is a 4 x 4 x 8 block of a unit
    lattice inside a one-site shell (tiles 1-2, 232 atoms), every r_eff
    1.4 A, so each sphere point of the block lies within 0.87 A of
    another atom.  Each tile's j-list holds tiles 0, 1, 2 with full masks
    and then `repeats` more entries over them, which tile 0 skips."""
    grid = np.stack(np.meshgrid(np.arange(6), np.arange(6), np.arange(10),
                                indexing="ij"), axis=-1).reshape(-1, 3)
    inner = ((grid >= 1) & (grid <= (4, 4, 8))).all(axis=1)
    coords = np.concatenate([grid[inner], grid[~inner]]).astype(np.float32)
    n = coords.shape[0]
    planes = np.zeros((fk.N_XFER_PLANES, 3 * ATOM_TILE), np.float32)
    planes[0:3, :n] = (coords - coords.mean(axis=0)).T
    planes[3, :n] = 1.4
    planes[4, :n] = np.arange(1, n + 1)
    order = np.arange(3 + repeats, dtype=np.uint32) % 3
    jlist = np.zeros((3, JLIST_ROWS), np.uint32)
    jlist[:, 0] = order.size
    jlist[:, 1:1 + order.size] = (np.uint32(0xFFFF) << np.uint32(16)) | order
    return planes, jlist


def saturation_counts(planes, jlist, sphere, *, check_every: int):
    """Occlusion counts [M] i32 and entries streamed per tile [T] i32 with
    the tile-saturation skip checked every `check_every` entries; the
    plain version on the CPU, csrc/saturation_count.cu on CUDA."""
    return fk.on_device(saturation_counts_reference, _kernels.saturation_count,
                        planes, jlist, sphere, check_every=check_every)


def run(triples, device, *, slots: int = _study.M_PAD, reps: int = 4,
        checks=CHECKS):
    """The study on one host-cull f32 chunk of `slots` slots on `device`.

    Returns {"structures", "atoms", "slots", "tiles", "failed",
    "entries", "margins", "variants": {name: {"first_ms", "ms",
    "matoms_s", "max_dcount", "skipped"}}} with variants prod and
    sat<check_every>; "entries" counts the j-list entries of all point
    passes, "skipped" the share of them a variant did not stream, and
    "margins" the (j, i, point) margins prod evaluates.
    """
    device = torch.device(device)
    planes, jl, real, n_atoms, tiles, failed = _study.host_cull_chunk(
        triples, device, slots
    )
    sphere = engine._sphere_device(_study.N_POINTS, device)
    passes, k = _kernels.point_passes(sphere.shape[0])
    entries = passes * int(jl[:, 0].clamp(0, JLIST_CAP).sum())
    points = passes * _kernels.SLICES * k
    margins = (int(_study.streamed_groups(jl).sum()) * J_GROUP * ATOM_TILE // 2
               * points)

    cases = [("prod", lambda: fk.fused_counts(planes, jl, sphere))]
    cases += [(f"sat{ce}", lambda ce=ce: saturation_counts(
        planes, jl, sphere, check_every=ce)) for ce in checks]
    variants, outs = _study.time_variants(cases, real, n_atoms, device, reps)
    for name, v in variants.items():
        n_streamed = (entries if name == "prod"
                      else int(outs[name][1].sum()))
        v["skipped"] = 1.0 - n_streamed / max(entries, 1)
    return {
        "structures": len(triples), "atoms": n_atoms, "slots": slots,
        "tiles": tiles, "failed": failed, "entries": entries,
        "margins": margins, "variants": variants,
    }


def report(result, device, head: str) -> None:
    print(f"{head}: {result['structures']} structures ({result['failed']} "
          f"host j-list overflows left out), {result['atoms']} atoms, "
          f"{result['tiles']} tiles in M={result['slots']} slots, "
          f"{result['entries']} j-list entries over all point passes, on "
          f"{_study.device_name(device)}", flush=True)
    for name, v in result["variants"].items():
        # Saturation variants skip part of prod's margins; their rate is
        # counted at prod's work.
        rate = _study.INSTR_PER_MARGIN * result["margins"] / (v["ms"] * 1e-3)
        print(f"{name:6s} first {v['first_ms']:9.1f} ms  warm {v['ms']:9.3f} "
              f"ms  {v['matoms_s']:7.2f} Matoms/s  {rate / 1e12:6.2f}T FP32 "
              f"instr/s at prod's work  max|dc|={v['max_dcount']}  skipped "
              f"{100 * v['skipped']:6.3f} % of entries", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("r4_saturation: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    triples = _study.load_corpus(argv[0] if argv else None)
    result = run(triples, device)
    report(result, device, "r4_saturation")
    return 0 if all(v["max_dcount"] == 0
                    for v in result["variants"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
