"""Per-half j-group admission and nibble group lists, on the card.

Port of the round-5 count-kernel study `scripts/r5_pair64.py`:

    python -m rustsasa_tpu_torch.scripts.r5_pair64 [corpus_dir]

packs one banded q16 chunk of up to 2,097,152 slots (structures of at
most W = 32 tiles), builds three j-lists on the device and times three
count kernels on it, each of which must give kernel 1's counts exactly:

  prod    build_jlist_banded + the production count kernel (fused_count);
  nibble  build_jlist_nibble: entries (gcount << 16) | j with the admitted
          group ids pre-compacted as 4-bit nibbles in two word planes,
          counted by csrc/nibble_count.cu (TPU: `_nibble_kernel`);
  pair64  build_jlist_banded_2h: a group mask per 64-atom half of the
          i-tile, counted by csrc/pair64_count.cu, where atoms 0-63 stream
          mask A's groups and atoms 64-127 mask B's (TPU: `_pair64_kernel`).

Per variant it reports first-call and warm milliseconds, Matoms/s, the
largest count difference to prod at real slots and the lane-weighted
j-atoms streamed per atom (the TPU study sized per-half admission at
911 -> 783).  Without a corpus directory the repository's FreeSASA test
structures are cycled.
"""

from __future__ import annotations

import sys

import torch

from ..ops import _kernels, engine
from ..ops import fused_kernel as fk
from ..ops.fused_kernel import ATOM_TILE, GROUPS_PER_TILE, J_GROUP
from . import _study

W = 32


def build_jlist_banded_2h(planes, qvalid, tmeta, *, w: int):
    """Per-half variant of build_jlist_banded -> (jlist_a, jmask_b), both
    [T, JLIST_ROWS] i32: entries (mask_a << 16) | j with the count in
    column 0, and mask_b in the low 16 bits of the same cells, where mask
    A (B) admits the j-groups in reach of i-atoms 0-63 (64-127).  An
    entry is kept when either mask is non-zero; the order is
    build_jlist_banded's.  Byte-equal to the reference script's."""
    j, act, sep2, bits = fk.band_cull(planes, qvalid, tmeta, w=w, halves=2)
    mask_a = fk.group_mask(bits[..., 0])
    mask_b = fk.group_mask(bits[..., 1])
    act = act & ((mask_a | mask_b) > 0)
    jlist_a, jmask_b = fk.compact_rows(act, sep2, (mask_a << 16) | j, mask_b)
    return jlist_a, jmask_b


def _pack_nibbles(mask):
    """i64 16-bit masks -> (w1, w2, count) i64: the set bit positions in
    ascending order, 4 bits each, the first 8 in w1 and the rest in w2."""
    npos = torch.zeros_like(mask)
    w1 = torch.zeros_like(mask)
    w2 = torch.zeros_like(mask)
    for g in range(GROUPS_PER_TILE):
        bit = (mask >> g) & 1
        w1 |= (g * (npos < 8) * bit) << (4 * npos.clamp_max(7))
        w2 |= (g * (npos >= 8) * bit) << (4 * (npos - 8).clamp_min(0))
        npos += bit
    return w1, w2, npos


def build_jlist_nibble(planes, qvalid, tmeta, *, w: int):
    """build_jlist_banded with pre-compacted group lists -> (jl, w1, w2),
    each [T, JLIST_ROWS] i32: entries (gcount << 16) | j with the count in
    column 0, and in the same cells of w1 and w2 the admitted group ids,
    4 bits each (list positions 0-7 and 8-15).  A nibble 15 in position 7
    wraps w1 negative, as the reference's int32 shift does.  Byte-equal to
    the reference script's `_build_masks(per_half=False)[0]`."""
    j, act, sep2, bits = fk.band_cull(planes, qvalid, tmeta, w=w)
    union = fk.group_mask(bits[..., 0])
    act = act & (union > 0)
    w1, w2, gcount = _pack_nibbles(union)
    jl, w1, w2 = fk.compact_rows(act, sep2, (gcount << 16) | j, w1, w2)
    return jl, w1, w2


def _with_masks(jlist, masks):
    """jlist's entries with their group masks replaced by the low 16 bits
    of `masks` (same shape); column 0 kept."""
    ent = jlist.to(torch.int64)
    rows = ((masks.to(torch.int64) & 0xFFFF) << 16) | (ent & 0xFFFF)
    rows[:, 0] = ent[:, 0]
    return rows.to(torch.int32)


def pair64_counts_reference(planes, jlist_a, jmask_b, sphere):
    """Plain-torch version of pair64_counts: kernel 1's plain version once
    with mask A (lanes 0-63 kept) and once with mask B (lanes 64-127)."""
    count_a = fk.fused_counts_reference(planes, jlist_a, sphere)
    count_b = fk.fused_counts_reference(
        planes, _with_masks(jlist_a, jmask_b), sphere
    )
    lane = torch.arange(planes.shape[1], device=planes.device) % ATOM_TILE
    return torch.where(lane < ATOM_TILE // 2, count_a, count_b)


def pair64_counts(planes, jlist_a, jmask_b, sphere):
    """Occlusion counts [M] i32 from build_jlist_banded_2h's j-lists; the
    plain version on the CPU, csrc/pair64_count.cu on CUDA."""
    return fk.on_device(pair64_counts_reference, _kernels.pair64_count,
                        planes, jlist_a, jmask_b, sphere)


def _nibble_masks(jl, w1, w2):
    """build_jlist_nibble's lists as kernel 1's j-lists: each entry's
    first gcount (at most 16) nibbles decoded into a group mask."""
    ent = jl.to(torch.int64) & 0xFFFFFFFF
    gcount = (ent >> 16).clamp_max(GROUPS_PER_TILE)
    words = (w1.to(torch.int64) & 0xFFFFFFFF, w2.to(torch.int64) & 0xFFFFFFFF)
    mask = torch.zeros_like(ent)
    for n in range(GROUPS_PER_TILE):
        g = (words[n // 8] >> (4 * (n % 8))) & 0xF
        mask |= torch.where(n < gcount, torch.ones_like(g) << g, 0)
    return _with_masks(jl, mask)


def nibble_counts_reference(planes, jl, w1, w2, sphere):
    """Plain-torch version of nibble_counts: kernel 1's plain version on
    the decoded group masks."""
    return fk.fused_counts_reference(planes, _nibble_masks(jl, w1, w2), sphere)


def nibble_counts(planes, jl, w1, w2, sphere):
    """Occlusion counts [M] i32 from build_jlist_nibble's lists; the plain
    version on the CPU, csrc/nibble_count.cu on CUDA."""
    return fk.on_device(nibble_counts_reference, _kernels.nibble_count,
                        planes, jl, w1, w2, sphere)


def run(triples, device, *, w: int = W, slots: int = _study.M_PAD,
        reps: int = 4):
    """The study on one banded q16 chunk of `slots` slots on `device`.

    Returns {"structures", "atoms", "slots", "tiles", "builders": {name:
    {"first_ms", "ms"}}, "variants": {name: {"first_ms", "ms",
    "matoms_s", "max_dcount", "j_atoms_per_atom", "margins"}}} with
    variants prod, nibble and pair64.  "j_atoms_per_atom" is the
    lane-weighted count of streamed j-atoms per atom over the tiles with
    a non-empty j-list, "margins" the (j, i, point) margins the kernel
    evaluates.
    """
    device = torch.device(device)
    planes, qvalid, tmeta_d, real, n_atoms, tiles = _study.banded_chunk(
        triples, device, slots
    )
    sphere = engine._sphere_device(_study.N_POINTS, device)

    builders = {}
    lists = {}
    for name, build in (
        ("banded", lambda: fk.build_jlist_banded(planes, qvalid, tmeta_d, w=w)),
        ("banded_2h", lambda: build_jlist_banded_2h(planes, qvalid, tmeta_d,
                                                    w=w)),
        ("nibble", lambda: build_jlist_nibble(planes, qvalid, tmeta_d, w=w)),
    ):
        first_ms, ms, lists[name] = _study.timed(build, device, reps)
        builders[name] = {"first_ms": first_ms, "ms": ms}
    jlist = lists["banded"]
    jlist_a, jmask_b = lists["banded_2h"]
    jl, w1, w2 = lists["nibble"]

    busy = jlist[:, 0] > 0
    passes, k = _kernels.point_passes(sphere.shape[0])
    points = passes * _kernels.SLICES * k  # the kernels' padded sphere
    variants, _ = _study.time_variants((
        ("prod", lambda: fk.fused_counts(planes, jlist, sphere)),
        ("nibble", lambda: nibble_counts(planes, jl, w1, w2, sphere)),
        ("pair64", lambda: pair64_counts(planes, jlist_a, jmask_b, sphere)),
    ), real, n_atoms, device, reps)
    for name, groups in (
        ("prod", _study.streamed_groups(jlist)),
        ("nibble", _study.streamed_groups(_nibble_masks(jl, w1, w2))),
        ("pair64", _study.streamed_groups(jlist_a, jmask_b)),
    ):
        lane_groups = int(groups.sum())  # x 2
        variants[name]["j_atoms_per_atom"] = (lane_groups * J_GROUP / 2
                                              / max(int(busy.sum()), 1))
        variants[name]["margins"] = lane_groups * J_GROUP * ATOM_TILE // 2 * points
    return {
        "structures": len(triples), "atoms": n_atoms, "slots": slots,
        "tiles": tiles, "builders": builders, "variants": variants,
    }


def report(result, device, head: str) -> None:
    print(f"{head}: {result['structures']} structures, {result['atoms']} "
          f"atoms, {result['tiles']} tiles in M={result['slots']} slots on "
          f"{_study.device_name(device)}", flush=True)
    for name, b in result["builders"].items():
        print(f"build {name:10s} first {b['first_ms']:9.1f} ms  warm "
              f"{b['ms']:9.3f} ms", flush=True)
    for name, v in result["variants"].items():
        rate = _study.INSTR_PER_MARGIN * v["margins"] / (v["ms"] * 1e-3)
        print(f"{name:8s} first {v['first_ms']:9.1f} ms  warm {v['ms']:9.3f} "
              f"ms  {v['matoms_s']:7.2f} Matoms/s  {rate / 1e12:6.2f}T FP32 "
              f"instr/s  max|dc|={v['max_dcount']}  "
              f"{v['j_atoms_per_atom']:7.1f} j-atoms/atom streamed",
              flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("r5_pair64: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    triples = _study.load_corpus(argv[0] if argv else None, max_tiles=W)
    result = run(triples, device)
    report(result, device, "r5_pair64")
    return 0 if all(v["max_dcount"] == 0
                    for v in result["variants"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
