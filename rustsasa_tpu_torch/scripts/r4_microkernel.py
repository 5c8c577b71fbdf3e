"""Loop micro-variants of the count kernel, on the card.

Port of the round-4 count-kernel study `scripts/r4_microkernel.py`:

    python -m rustsasa_tpu_torch.scripts.r4_microkernel [corpus_dir]

packs one host-cull f32 chunk (pack_structures: real group ids, j-lists
culled on the host) of up to 2,097,152 slots and times kernel 1 (k1)
against csrc/micro_count.cu in its five loop shapes:

  prod    one kept row per iteration (kernel 1's loop);
  split2  two running-max arrays taking a chunk's kept rows in turn,
          merged at the end;
  g16     two kept rows per iteration, g24 three (an odd tail repeats
          the last kept row);
  nosmem  no reach test: all 16 groups of every entry, each limit offset
          by a gate of 0 or -1e30 from the mask bit (no compaction).

The first four run kernel 1's layout and reach skip (csrc/reach_ring.cuh):
16 lanes an atom, a ballot over each admitted chunk's kept rows.  All
take the max of the reference's margins (leaving out only rows whose
margins are <= 0; nosmem adds ones at or below -1e30), so the counts
must equal kernel 1's exactly.  Per variant it
reports milliseconds, the ratio to k1, Matoms/s, the FP32 instruction
rate at its own work and the largest count difference to k1 at real
slots.  Without a corpus directory the repository's FreeSASA test
structures are cycled.
"""

from __future__ import annotations

import sys

import torch

from ..ops import _kernels, engine
from ..ops import fused_kernel as fk
from ..ops.fused_kernel import ATOM_TILE, GROUPS_PER_TILE, J_GROUP
from . import _study

VARIANTS = _kernels.MICRO_VARIANTS


def micro_counts_reference(planes, jlist, sphere, *, variant: str):
    """Plain-torch version of micro_counts: kernel 1's plain version for
    every variant.  The variants take the max of the same margins in
    another order (max is exact), repeat a group (idempotent), or, in
    nosmem, add margins of non-admitted groups whose limit is offset by
    -1e30; those stay at or below -1e30, where every valid point's
    running max starts."""
    _kernels.variant_code("micro_counts", variant, VARIANTS)
    return fk.fused_counts_reference(planes, jlist, sphere)


def _kept_order(rows, variant: str):
    """The j-rows a warp streams for one chunk's ballot `rows` (its kept
    rows in row order) in csrc/micro_count.cu's loop shape -> [(row,
    accumulator)]: split2 gives the rows to its two running maxima in
    turn, g16 and g24 take two or three rows an iteration, an odd tail
    repeating the last kept row."""
    if variant == "split2":
        return [(r, i % 2) for i, r in enumerate(rows)]
    group = {"g16": 2, "g24": 3}.get(variant, 1)
    tail = -len(rows) % group
    return [(r, 0) for r in rows + rows[-1:] * tail]


def micro_counts_kept_reference(planes, jlist, sphere, *, variant: str):
    """Plain model of csrc/micro_count.cu's loop order -> counts [M] i32:
    per tile, entry and admitted 32-row chunk, each warp of
    fused_kernel.WARP_ATOMS atoms takes the rows one of its atoms keeps
    (fused_kernel.reach_keep_row; lim -1e30 for an atom that does not) in
    the variant's order (_kept_order), split2 merging its second running
    max after the entries; nosmem takes every row of every entry on a tile
    of the chunk, its limit offset by a gate of 0 or -1e30 from the group
    bit.  Its counts must equal micro_counts_reference's at every slot.
    A loop per warp and chunk: for small chunks."""
    _kernels.variant_code("micro_counts", variant, VARIANTS)
    m = planes.shape[1]
    t = m // ATOM_TILE
    dev = planes.device
    sx, sy, sz = (sphere[:, c] for c in range(3))
    far_ok = fk.sphere_far_ok(sphere)
    warps = ATOM_TILE // fk.WARP_ATOMS
    lane = torch.arange(ATOM_TILE, device=dev)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    for ti in range(t):
        xi, yi, zi, ri, gi = (planes[row, ti * ATOM_TILE:(ti + 1) * ATOM_TILE]
                              for row in range(5))
        r2i = ri * ri
        inv2ri = torch.full_like(ri, 0.5) / torch.clamp_min(ri, 1e-6)
        occ = torch.full((2, ATOM_TILE, sphere.shape[0]), fk._NEG_BIG,
                         dtype=torch.float32, device=dev)
        for e in range(min(max(int(jlist[ti, 0]), 0), fk.JLIST_CAP)):
            ent = int(jlist[ti, 1 + e]) & 0xFFFFFFFF
            jt, mask = ent & 0xFFFF, ent >> 16
            if jt >= t or (variant != "nosmem" and mask == 0):
                continue
            admitted = ((mask >> (lane // J_GROUP)) & 1).bool()  # [J]
            xk, yk, zk, rk, gk = (
                planes[row, jt * ATOM_TILE:(jt + 1) * ATOM_TILE][:, None]
                for row in range(5))  # [J, 1]
            vx, vy, vz = xi - xk, yi - yk, zi - zk  # [J, A]
            v2 = (vx * vx + vy * vy) + vz * vz
            lim = ((rk * rk - v2) - r2i) * inv2ri
            dots = (sx * vx[..., None]
                    + (sy * vy[..., None] + sz * vz[..., None]))  # [J, A, P]
            if variant == "nosmem":
                lim = torch.where((gk == gi) | (gk == 0.0), fk._NEG_BIG, lim)
                gate = torch.where(admitted, 0.0, fk._NEG_BIG)[:, None]
                margins = (lim + gate)[..., None] - dots
                occ[0] = torch.maximum(occ[0], margins.amax(dim=0))
                continue
            keep = (fk.reach_keep_row(v2, ri, rk, gi, gk, far_ok)
                    & admitted[:, None])
            margins = torch.where(keep, lim, fk._NEG_BIG)[..., None] - dots
            ballot = keep.reshape(ATOM_TILE, warps, fk.WARP_ATOMS).any(dim=-1)
            for c in range(ATOM_TILE // 32):
                for w in range(warps):
                    rows = (c * 32 + torch.nonzero(
                        ballot[c * 32:(c + 1) * 32, w]).flatten()).tolist()
                    atoms = slice(w * fk.WARP_ATOMS, (w + 1) * fk.WARP_ATOMS)
                    for r, acc in _kept_order(rows, variant):
                        occ[acc, atoms] = torch.maximum(occ[acc, atoms],
                                                        margins[r, atoms])
        acc = (occ.amax(dim=0) <= 0.0) & (sphere[:, 3] > 0.0)
        out[ti * ATOM_TILE:(ti + 1) * ATOM_TILE] = acc.sum(
            dim=-1, dtype=torch.int32)
    return out


def micro_counts(planes, jlist, sphere, *, variant: str):
    """Occlusion counts [M] i32 through loop shape `variant`; the plain
    version on the CPU, csrc/micro_count.cu on CUDA."""
    return fk.on_device(micro_counts_reference, _kernels.micro_count,
                        planes, jlist, sphere, variant=variant)


def streamed_groups(jlist):
    """{variant: 8-atom groups each variant takes per point pass, summed
    over the chunk}: the admitted groups, whose rows the four reach-skip
    variants test (prod, split2, g16, g24: kernel 1's), or all 16 of every
    entry on a tile of the chunk (nosmem)."""
    t = jlist.shape[0]
    ent = jlist[:, 1:].to(torch.int64) & 0xFFFFFFFF
    live = ((torch.arange(ent.shape[1], device=ent.device)
             < jlist[:, 0:1].clamp(0, fk.JLIST_CAP)) & ((ent & 0xFFFF) < t))
    n = int((_study._popcount16(ent >> 16) * live).sum())
    return {**dict.fromkeys(VARIANTS[:-1], n),
            "nosmem": GROUPS_PER_TILE * int(live.sum())}


def run(triples, device, *, slots: int = _study.M_PAD, reps: int = 4,
        variants=VARIANTS):
    """The study on one host-cull f32 chunk of `slots` slots on `device`.

    Returns {"structures", "atoms", "slots", "tiles", "failed",
    "variants": {name: {"first_ms", "ms", "matoms_s", "max_dcount",
    "mean_dcount", "groups", "margins", "instr"}}} with k1 (kernel 1)
    first, then each variant; "groups" counts the 8-atom groups a variant
    takes per point pass (streamed_groups; for k1, the admitted ones),
    "margins" the (j, i, point) margins of those groups and "instr" the
    FP32 instructions of a variant's work: for kernel 1 and the four
    reach-skip variants, which stream only rows some atom of a warp keeps,
    what these inputs need (_study.k1_instructions); for nosmem 7 a margin
    of its groups.
    """
    device = torch.device(device)
    planes, jl, real, n_atoms, tiles, failed = _study.host_cull_chunk(
        triples, device, slots
    )
    sphere = engine._sphere_device(_study.N_POINTS, device)
    passes, k = _kernels.lane_passes(sphere.shape[0])
    points = passes * _kernels.COUNT_LANES * k
    cases = [("k1", lambda: fk.fused_counts(planes, jl, sphere))]
    cases += [(v, lambda v=v: micro_counts(planes, jl, sphere, variant=v))
              for v in variants]
    result, _ = _study.time_variants(cases, real, n_atoms, device, reps)
    groups = streamed_groups(jl)
    groups["k1"] = groups["prod"]
    needed = _study.k1_instructions(planes, jl, sphere)
    for name, v in result.items():
        v["groups"] = groups[name]
        v["margins"] = groups[name] * J_GROUP * ATOM_TILE * points
        v["instr"] = (_study.INSTR_PER_MARGIN * v["margins"]
                      if name == "nosmem" else needed)
    return {
        "structures": len(triples), "atoms": n_atoms, "slots": slots,
        "tiles": tiles, "failed": failed, "variants": result,
    }


def report(result, device, head: str) -> None:
    print(f"{head}: {result['structures']} structures ({result['failed']} "
          f"host j-list overflows left out), {result['atoms']} atoms, "
          f"{result['tiles']} tiles in M={result['slots']} slots, on "
          f"{_study.device_name(device)}", flush=True)
    k1 = result["variants"]["k1"]
    for name, v in result["variants"].items():
        rate = v["instr"] / (v["ms"] * 1e-3)
        print(f"{name:7s} first {v['first_ms']:9.1f} ms  warm {v['ms']:9.3f} "
              f"ms ({v['ms'] / k1['ms']:.3f}x k1)  {v['matoms_s']:7.2f} "
              f"Matoms/s  {rate / 1e12:6.2f}T FP32 instr/s at its own work  "
              f"groups {v['groups'] / k1['groups']:.3f}x k1's  "
              f"max|dc|={v['max_dcount']}", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("r4_microkernel: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    triples = _study.load_corpus(argv[0] if argv else None)
    result = run(triples, device)
    report(result, device, "r4_microkernel")
    return 0 if all(v["max_dcount"] == 0
                    for v in result["variants"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
