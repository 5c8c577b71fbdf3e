"""Per-half j-group admission and nibble group lists, on the card.

Port of the round-5 count-kernel study `scripts/r5_pair64.py`:

    python -m rustsasa_tpu_torch.scripts.r5_pair64 [corpus_dir]

packs one banded q16 chunk of up to 2,097,152 slots (structures of at
most W = 32 tiles), builds three j-lists on the device and times three
count kernels on it, each of which must give kernel 1's counts exactly:

  prod    build_jlist_banded + the production count kernel (fused_count);
  nibble  build_jlist_nibble: entries (gcount << 16) | j with the admitted
          group ids pre-compacted as 4-bit nibbles in two word planes,
          counted by csrc/nibble_count.cu (TPU: `_nibble_kernel`), which
          packs an entry's groups four to a reach-test chunk on kernel
          1's layout (nibble_counts_kept_reference is its plain model);
  pair64  build_jlist_banded_2h: a group mask per 64-atom half of the
          i-tile, counted by csrc/pair64_count.cu (TPU: `_pair64_kernel`)
          on kernel 1's layout, where the CTAs of atoms 0-63 stage the
          entries of mask A and stream its groups and those of atoms
          64-127 mask B's (pair64_counts_kept_reference is its plain
          model).

The builders are timed alike: the production builder's plain version
(`build_jlist_banded_reference`, "banded"), beside the plain torch of the
two study builders, and the production builder as the main path runs it
("banded_kernel": the `band_jlist` kernel on the card), which must give
"banded"'s j-lists byte for byte.
Per variant it reports first-call and warm milliseconds, Matoms/s, the
largest count difference to prod at real slots and the lane-weighted
j-atoms streamed per atom (the TPU study sized per-half admission at
911 -> 783), for nibble the 32-row reach chunks a live entry tests,
packed, against kernel 1's chunks with an admitted group, and for pair64
the live entries and reach chunks a CTA stages against kernel 1's.
Without a corpus directory the repository's FreeSASA test structures are
cycled.
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


def nibble_chunk_rows(jl, w1, w2, tile: int, e: int):
    """The j-rows csrc/nibble_count.cu's lanes test for entry e of tile's
    nibble list -> [chunks, 32] i64, -1 where a lane is idle: lane l of
    chunk c takes row 8 g[4c + l // 8] + l % 8 while 4c + l // 8 <
    gcount (at most 16), g[n] the list's nibble n."""
    gcount = min((int(jl[tile, 1 + e]) & 0xFFFFFFFF) >> 16, GROUPS_PER_TILE)
    words = (int(w1[tile, 1 + e]) & 0xFFFFFFFF, int(w2[tile, 1 + e])
             & 0xFFFFFFFF)
    groups = [(words[n // 8] >> (4 * (n % 8))) & 0xF for n in range(gcount)]
    rows = torch.full((-(-gcount // 4), 32), -1, dtype=torch.int64)
    for lane in range(32):
        for c in range(rows.shape[0]):
            n = 4 * c + lane // J_GROUP
            if n < gcount:
                rows[c, lane] = J_GROUP * groups[n] + lane % J_GROUP
    return rows


def _counts_kept(planes, sphere, chunks_of):
    """Counts [M] i32 of a count kernel on kernel 1's layout that tests,
    for tile ti, the chunks chunks_of(ti) yields as (atoms, rows): the
    tile's atoms `atoms` (a slice of its 128) against the j-rows `rows`
    [R] i64 (slots of the chunk).  In each chunk a warp of
    fused_kernel.WARP_ATOMS atoms streams the rows one of its atoms keeps
    (fused_kernel.reach_keep_row; lim -1e30 for an atom that does not).
    A loop per tile and chunk: for small chunks."""
    m = planes.shape[1]
    dev = planes.device
    sx, sy, sz = (sphere[:, c] for c in range(3))
    far_ok = fk.sphere_far_ok(sphere)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    for ti in range(m // ATOM_TILE):
        tile = slice(ti * ATOM_TILE, (ti + 1) * ATOM_TILE)
        xi, yi, zi, ri, gi = (planes[row, tile] for row in range(5))
        r2i = ri * ri
        inv2ri = torch.full_like(ri, 0.5) / torch.clamp_min(ri, 1e-6)
        occ = torch.full((ATOM_TILE, sphere.shape[0]), fk._NEG_BIG,
                         dtype=torch.float32, device=dev)
        for atoms, rows in chunks_of(ti):
            xk, yk, zk, rk, gk = (planes[row, rows.to(dev)][:, None]
                                  for row in range(5))  # [R, 1]
            vx, vy, vz = xi[atoms] - xk, yi[atoms] - yk, zi[atoms] - zk
            v2 = (vx * vx + vy * vy) + vz * vz  # [R, A]
            lim = ((rk * rk - v2) - r2i[atoms]) * inv2ri[atoms]
            keep = fk.reach_keep_row(v2, ri[atoms], rk, gi[atoms], gk,
                                     far_ok)
            lim = torch.where(keep, lim, fk._NEG_BIG)
            warp = keep.reshape(keep.shape[0], -1, fk.WARP_ATOMS).any(
                dim=-1).repeat_interleave(fk.WARP_ATOMS, dim=-1)
            margins = lim[..., None] - (
                sx * vx[..., None]
                + (sy * vy[..., None] + sz * vz[..., None]))  # [R, A, P]
            margins = torch.where(warp[..., None], margins, float("-inf"))
            occ[atoms] = torch.maximum(occ[atoms], margins.amax(dim=0))
        acc = (occ <= 0.0) & (sphere[:, 3] > 0.0)
        out[tile] = acc.sum(dim=-1, dtype=torch.int32)
    return out


def nibble_counts_kept_reference(planes, jl, w1, w2, sphere):
    """Plain model of csrc/nibble_count.cu -> counts [M] i32: per tile and
    live entry (gcount != 0, j-tile in the chunk), the packed chunks of
    nibble_chunk_rows, each against the tile's 128 atoms (_counts_kept),
    a row twice where the list names a group twice.  Its counts must
    equal nibble_counts_reference's at every slot."""
    t = planes.shape[1] // ATOM_TILE

    def chunks(ti):
        for e in range(min(max(int(jl[ti, 0]), 0), fk.JLIST_CAP)):
            jt = int(jl[ti, 1 + e]) & 0xFFFF
            if jt >= t:
                continue
            for chunk in nibble_chunk_rows(jl, w1, w2, ti, e):
                yield slice(0, ATOM_TILE), chunk[chunk >= 0] + jt * ATOM_TILE

    return _counts_kept(planes, sphere, chunks)


def pair64_counts_kept_reference(planes, jlist_a, jmask_b, sphere):
    """Plain model of csrc/pair64_count.cu -> counts [M] i32: each half of
    a tile (atoms 0-63 with mask A, the high 16 bits of jlist_a's entry;
    atoms 64-127 with mask B, the low 16 bits of jmask_b's cell) takes the
    entries live for it (its mask non-zero, the j-tile in the chunk) and,
    as kernel 1 does, each 32-row chunk of the j-tile holding an admitted
    group: its admitted groups' rows against the half's atoms
    (_counts_kept).  Its counts must equal pair64_counts_reference's at
    every slot."""
    t = planes.shape[1] // ATOM_TILE
    lane_group = torch.arange(32) // J_GROUP

    def chunks(ti):
        n = min(max(int(jlist_a[ti, 0]), 0), fk.JLIST_CAP)
        for half, cells in enumerate((jlist_a, jmask_b)):
            atoms = slice(half * ATOM_TILE // 2, (half + 1) * ATOM_TILE // 2)
            for e in range(n):
                jt = int(jlist_a[ti, 1 + e]) & 0xFFFF
                cell = int(cells[ti, 1 + e]) & 0xFFFFFFFF
                mask = cell >> 16 if half == 0 else cell & 0xFFFF
                if jt >= t or mask == 0:
                    continue
                for c in range(ATOM_TILE // 32):
                    gm = (mask >> (4 * c)) & 0xF
                    if gm:
                        lanes = torch.nonzero((gm >> lane_group) & 1)[:, 0]
                        yield atoms, jt * ATOM_TILE + c * 32 + lanes

    return _counts_kept(planes, sphere, chunks)


def reach_chunks(jlist, nibble: bool = False) -> tuple[int, int]:
    """(32-row reach-test chunks, live entries) of a j-list: kernel 1
    tests each of an entry's four chunks that holds an admitted group
    (entries (mask << 16) | j); with nibble, csrc/nibble_count.cu packs
    an entry's gcount groups four to a chunk (entries (gcount << 16) |
    j).  An entry is live when its groups are not 0 and its j-tile is in
    the chunk."""
    t = jlist.shape[0]
    ent = jlist[:, 1:].to(torch.int64) & 0xFFFFFFFF
    high = ent >> 16
    live = ((torch.arange(ent.shape[1], device=ent.device)
             < jlist[:, 0:1].clamp(0, fk.JLIST_CAP))
            & ((ent & 0xFFFF) < t) & (high != 0))
    if nibble:
        chunks = (high.clamp_max(GROUPS_PER_TILE) + 3) // 4
    else:
        chunks = sum(((high >> (4 * c)) & 0xF) != 0 for c in range(4))
    return int((chunks * live).sum()), int(live.sum())


def pair64_staged(jlist, jlist_a, jmask_b) -> dict:
    """{"pair64", "prod"}: each {"entries", "chunks"}, the live entries a
    CTA stages and the 32-row reach chunks it tests (reach_chunks),
    averaged over the four CTAs of every tile: pair64's CTAs of atoms
    0-63 take mask A's entries, those of 64-127 mask B's; kernel 1's take
    jlist's."""
    t = jlist.shape[0]
    halves = [reach_chunks(lst) for lst in (jlist_a,
                                            _with_masks(jlist_a, jmask_b))]
    chunks, live = reach_chunks(jlist)
    return {"pair64": {"entries": (halves[0][1] + halves[1][1]) / (2 * t),
                       "chunks": (halves[0][0] + halves[1][0]) / (2 * t)},
            "prod": {"entries": live / t, "chunks": chunks / t}}


def nibble_counts(planes, jl, w1, w2, sphere):
    """Occlusion counts [M] i32 from build_jlist_nibble's lists; the plain
    version on the CPU, csrc/nibble_count.cu on CUDA."""
    return fk.on_device(nibble_counts_reference, _kernels.nibble_count,
                        planes, jl, w1, w2, sphere)


def run(triples, device, *, w: int = W, slots: int = _study.M_PAD,
        reps: int = 4):
    """The study on one banded q16 chunk of `slots` slots on `device`.

    Returns {"structures", "atoms", "slots", "tiles", "kernel_equal",
    "builders": {name: {"first_ms", "ms"}}, "variants": {name: {"first_ms",
    "ms", "matoms_s", "max_dcount", "j_atoms_per_atom", "margins",
    "instr"}}} with variants prod, nibble and pair64; nibble's also has
    "chunks_per_entry": {"nibble", "prod"}, the reach-test chunks a live
    entry runs in each kernel (reach_chunks), and pair64's "per_cta":
    {"pair64", "prod"}, each {"entries", "chunks"}: the live entries a CTA
    stages and the reach chunks it tests, averaged over the chunk's CTAs
    (pair64_staged).  "j_atoms_per_atom" is the lane-weighted count of
    admitted j-atoms per atom over the tiles with a non-empty j-list,
    "margins" their (j, i, point) margins, "instr" the FP32 instructions
    of what these inputs need (_study.k1_instructions): the three
    kernels run on kernel 1's layout and stream only rows some atom of a
    warp keeps.
    """
    device = torch.device(device)
    planes, qvalid, tmeta_d, real, n_atoms, tiles = _study.banded_chunk(
        triples, device, slots
    )
    sphere = engine._sphere_device(_study.N_POINTS, device)

    builders = {}
    lists = {}
    for name, build in (
        ("banded", lambda: fk.build_jlist_banded_reference(
            planes, qvalid, tmeta_d, w=w)),
        ("banded_kernel", lambda: fk.build_jlist_banded(planes, qvalid,
                                                        tmeta_d, w=w)),
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
    needed = _study.k1_instructions(planes, jlist, sphere)
    for v in variants.values():
        v["instr"] = needed
    per_entry = {}
    for name, lst, packed in (("nibble", jl, True), ("prod", jlist, False)):
        chunks, live = reach_chunks(lst, nibble=packed)
        per_entry[name] = chunks / max(live, 1)
    variants["nibble"]["chunks_per_entry"] = per_entry
    variants["pair64"]["per_cta"] = pair64_staged(jlist, jlist_a, jmask_b)
    return {
        "structures": len(triples), "atoms": n_atoms, "slots": slots,
        "tiles": tiles, "builders": builders, "variants": variants,
        "kernel_equal": bool(torch.equal(lists["banded_kernel"], jlist)),
    }


def report(result, device, head: str) -> None:
    print(f"{head}: {result['structures']} structures, {result['atoms']} "
          f"atoms, {result['tiles']} tiles in M={result['slots']} slots on "
          f"{_study.device_name(device)}", flush=True)
    for name, b in result["builders"].items():
        print(f"build {name:13s} first {b['first_ms']:9.1f} ms  warm "
              f"{b['ms']:9.3f} ms", flush=True)
    print(f"banded_kernel j-lists byte-equal to banded: "
          f"{result['kernel_equal']}", flush=True)
    for name, v in result["variants"].items():
        rate = v["instr"] / (v["ms"] * 1e-3)
        print(f"{name:8s} first {v['first_ms']:9.1f} ms  warm {v['ms']:9.3f} "
              f"ms  {v['matoms_s']:7.2f} Matoms/s  {rate / 1e12:6.2f}T FP32 "
              f"instr/s  max|dc|={v['max_dcount']}  "
              f"{v['j_atoms_per_atom']:7.1f} j-atoms/atom streamed",
              flush=True)
    per_entry = result["variants"]["nibble"]["chunks_per_entry"]
    print(f"reach chunks a live entry: nibble {per_entry['nibble']:.4f} "
          f"(packed), prod {per_entry['prod']:.4f} ("
          f"{per_entry['nibble'] / max(per_entry['prod'], 1e-12):.4f} of "
          f"prod's)", flush=True)
    staged = result["variants"]["pair64"]["per_cta"]
    ratio = {key: staged["pair64"][key] / max(staged["prod"][key], 1e-12)
             for key in ("entries", "chunks")}
    print("a CTA stages: " + ", ".join(
        f"{name} {v['entries']:.2f} live entries and {v['chunks']:.2f} "
        f"reach chunks" for name, v in staged.items())
        + f" (pair64 {ratio['entries']:.4f} and {ratio['chunks']:.4f} of "
        "prod's)", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("r5_pair64: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    triples = _study.load_corpus(argv[0] if argv else None, max_tiles=W)
    result = run(triples, device)
    report(result, device, "r5_pair64")
    return 0 if result["kernel_equal"] and all(
        v["max_dcount"] == 0 for v in result["variants"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
