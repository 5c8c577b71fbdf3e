"""What the count-kernel studies share: corpus selection, the two chunk
wires, timing against kernel 1 and the real-slot mask.

The studies run one full-size chunk: the corpus's structures, selected
at residue level as `process_directory` selects them, packed into up to
M_PAD = 2,097,152 atom slots (the TPU scripts' chunk), at 100 points.
"""

from __future__ import annotations

import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import fused_kernel as fk
from ..ops.fused_kernel import ATOM_TILE, GROUPS_PER_TILE, INSTR_PER_MARGIN

PROBE = 1.4
N_POINTS = 100
M_PAD = 2_097_152
# The repository's FreeSASA test structures: the corpus when none is given.
TEST_STRUCTURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "data", "freesasa_pdbs",
)
STRUCTURE_SUFFIXES = (".pdb", ".cif", ".pdb.gz", ".cif.gz")
# band_structures: atoms per cubic angstrom (about a folded protein's
# heavy atoms), the largest structure, and the tiles of padding (no real
# atom, tmeta (0, 0)) band_chunk_wire appends.
BAND_DENSITY = 0.1
BAND_MAX_ATOMS = 16_000
BAND_PAD_TILES = 2
BAND_RADII = np.array([1.4, 1.55, 1.6, 1.7, 1.8, 1.9, 2.0], np.float32)


def bench_corpus(corpus_dir=None) -> str:
    """`corpus_dir`, or the port's bench corpus (`bench.build_corpus`
    under `bench.WORK_DIR`), built there if absent."""
    if corpus_dir is not None:
        return corpus_dir
    from .. import bench

    corpus = os.path.join(bench.WORK_DIR, "corpus")
    if not (os.path.isdir(corpus) and os.listdir(corpus)):
        bench.build_corpus(corpus)
    return corpus


def corpus_files(corpus_dir=None) -> list[str]:
    """The paths of `bench_corpus(corpus_dir)`'s files in name order."""
    src = bench_corpus(corpus_dir)
    return [os.path.join(src, f) for f in sorted(os.listdir(src))]


def select(path):
    """(coords, radii, gids) of one file at residue level, as
    process_directory selects it."""
    from ..native import native_process_file

    ns = native_process_file(
        path, level="residue", include_hydrogens=False,
        include_hetatms=False, read_radii_from_occupancy=False,
        allow_vdw_fallback=False,
    )
    try:
        return ns.coords.copy(), ns.radii.copy(), ns.gids.copy()
    finally:
        ns.close()


def load_corpus(corpus_dir=None, *, slots=M_PAD, max_tiles=None):
    """Selected structures of `corpus_dir`'s files in name order (without
    a directory: the repository's FreeSASA test structures, cycled),
    skipping any of more than `max_tiles` 128-atom tiles, until the next
    one would overflow `slots` atom slots."""
    src = corpus_dir or TEST_STRUCTURES
    names = sorted(f for f in os.listdir(src) if f.endswith(STRUCTURE_SUFFIXES))
    if not names:
        raise ValueError(f"no structure files in {src}")
    files = (os.path.join(src, f) for f in
             (itertools.cycle(names) if corpus_dir is None else names))
    triples, used, skipped = [], 0, 0
    with ThreadPoolExecutor(max_workers=4) as pool:
        while batch := list(itertools.islice(files, 32)):
            for t in pool.map(select, batch):
                nt = -(-t[0].shape[0] // ATOM_TILE)
                if max_tiles is not None and nt > max_tiles:
                    skipped += 1
                    if skipped > len(names) and not triples:
                        raise ValueError(f"no structure of <= {max_tiles} tiles")
                    continue
                if used + nt * ATOM_TILE > slots:
                    return triples
                triples.append(t)
                used += nt * ATOM_TILE
    return triples


def host_cull_chunk(triples, device, slots: int = M_PAD):
    """pack_structures' f32 wire of `triples` (real group ids, j-lists
    culled on the host), zero-padded to `slots` slots, on `device` ->
    (planes [5, slots] f32, jlist [slots/128, JLIST_ROWS] i32, real
    [slots] bool, atoms, packed tiles, structures left out for a j-list
    overflow)."""
    planes5, jlist, offsets, failed = fk.pack_structures(triples, PROBE,
                                                         N_POINTS)
    m = planes5.shape[1]
    if m > slots:
        raise ValueError(f"{m} slots packed, more than {slots}")
    planes, jl = fk.to_device((
        np.pad(planes5, ((0, 0), (0, slots - m))),
        np.pad(jlist, ((0, (slots - m) // ATOM_TILE), (0, 0))),
    ), device)
    atoms = sum(off[1] for off in offsets if off is not None)
    return (planes, jl, real_slots(offsets, slots, device), atoms,
            m // ATOM_TILE, len(failed))


def banded_chunk(triples, device, slots: int = M_PAD):
    """pack_structures_q16's wire of `triples`, zero-padded to `slots`
    slots, on `device` and dequantized -> (planes [N_PLANES, slots] f32,
    qvalid [slots] bool, tmeta [slots/128, 2] i32, real [slots] bool,
    atoms, packed tiles)."""
    planes4, tparams, tmeta, offsets = fk.pack_structures_q16(triples, PROBE)
    m = planes4.shape[1]
    if m > slots:
        raise ValueError(f"{m} slots packed, more than {slots}")
    pad_t = (slots - m) // ATOM_TILE
    planes4, tparams, tmeta = fk.to_device((
        np.pad(planes4, ((0, 0), (0, slots - m))),
        np.pad(tparams, ((0, pad_t), (0, 0))),
        np.pad(tmeta, ((0, pad_t), (0, 0))),
    ), device)
    planes, qvalid = fk.dequant_q16(planes4, tparams)
    atoms = sum(t[0].shape[0] for t in triples)
    return (planes, qvalid, tmeta, real_slots(offsets, slots, device), atoms,
            m // ATOM_TILE)


def band_structures(w: int, seed: int) -> list:
    """Seeded synthetic (coords, radii, gids) triples for band width w
    (one of fk.W_BUCKETS): 3, 100 and 700 atoms and a largest of
    min(128 w - 100, BAND_MAX_ATOMS), whose tiles make the engine pick
    w; each uniform in a cube at BAND_DENSITY atoms/A^3 (at most 55 A
    wide, so the q13 wire takes them too)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (3, 100, 700, min(ATOM_TILE * w - 100, BAND_MAX_ATOMS)):
        side = (n / BAND_DENSITY) ** (1.0 / 3.0)
        coords = (rng.uniform(0.0, side, (n, 3)) + 40.0).astype(np.float32)
        out.append((coords, rng.choice(BAND_RADII, n),
                    np.arange(n, dtype=np.int32)))
    return out


def band_chunk_wire(structures, wire: str, pad_tiles: int = BAND_PAD_TILES):
    """`structures` packed on the banded `wire` ("q13" or "q16") with
    `pad_tiles` tiles of padding appended -> (numpy wire arrays, tmeta,
    offsets): (wire_a, wire_b, palette, tparams) or (planes4, tparams)."""
    pad = pad_tiles * ATOM_TILE

    def slots(a):
        return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])

    def tiles(a):
        return np.pad(a, ((0, pad_tiles), (0, 0)))

    if wire == "q13":
        packed = fk.pack_structures_q13(structures, PROBE)
        if packed is None:
            raise ValueError("the q13 wire refuses these structures")
        wire_a, wire_b, palette, tparams, tmeta, offsets = packed
        arrays = (slots(wire_a), slots(wire_b), palette, tiles(tparams))
    elif wire == "q16":
        planes4, tparams, tmeta, offsets = fk.pack_structures_q16(structures,
                                                                  PROBE)
        arrays = (slots(planes4), tiles(tparams))
    else:
        raise ValueError(f"unknown banded wire {wire!r}")
    return arrays, tiles(tmeta), offsets


# tangent_chunk: radii on the q13 wire's lattice (multiples of 2^-13)
# between these bounds, and the spacing of the clusters (A).  With far,
# half the partners sit up to TANGENT_FAR past tangency (relative), and
# half of them have r_j / r_i in TANGENT_RATIO, about the skip's guard of
# 1/8 (fused_kernel.RADIUS_RATIO), the rest in [TANGENT_RATIO[1], 1].
TANGENT_R = (2.4, 3.6)
TANGENT_SPACING = 40.0
TANGENT_FAR = 2.0 * 2.0 ** -14
TANGENT_RATIO = (0.11, 0.16)


def tangent_chunk(n_points: int, n_atoms: int = 400, seed: int = 0,
                  ulps: float = 8.0, far: bool = False, slack=None):
    """Near-tangent pairs for the count kernel's reach skip, as numpy
    (planes [8, M] f32, jlist [M/128, 128] i32, real [M] bool), M the
    atoms rounded up to whole tiles, every tile's j-list admitting every
    group of every tile.

    Clusters TANGENT_SPACING apart, each an i-atom and up to 60 partner
    j-atoms, one for each of distinct points s_k of the n_points sphere,
    at c_j = c_i + d s_k with d = (r_i + r_j)(1 + t 2^-24), t uniform in
    [-ulps, ulps]: j's sphere touches i's at s_k, within a few roundings.
    Radii are on the q13 lattice in TANGENT_R; gids are slot + 1.  With
    far, half the partners sit at the edge of the kernel's distance skip,
    d = (r_i + r_j) sqrt(slack)(1 + t 2^-24) (slack: by default
    fused_kernel.REACH_SLACK; BF16_SLACK for the bf16 skip), the rest
    at d = (r_i + r_j)(1 + t), t uniform in [0, TANGENT_FAR], across
    where the skip starts; the partners' radii as TANGENT_RATIO says, so
    the skip meets its worst radius ratio and pairs just past its guard.
    """
    from ..ops.sphere import sphere_points

    rng = np.random.default_rng(seed)
    edge = fk.REACH_SLACK if slack is None else slack
    pts = sphere_points(n_points).astype(np.float64)
    q_lo, q_hi = (int(r * fk.R_QUANT) for r in TANGENT_R)
    coords, radii = [], []
    c = 0
    while len(coords) < n_atoms:
        k = min(60, n_points, n_atoms - len(coords) - 1)
        if k < 1:
            break
        center = 50.0 + TANGENT_SPACING * np.array(
            [c % 4, (c // 4) % 4, c // 16], np.float64)
        ri = rng.integers(q_lo, q_hi) / fk.R_QUANT
        coords.append(center)
        radii.append(ri)
        for s in rng.choice(n_points, k, replace=False):
            if not far:
                rj = rng.integers(q_lo, q_hi) / fk.R_QUANT
                d = (ri + rj) * (1.0 + rng.uniform(-ulps, ulps) * 2.0 ** -24)
            else:
                lo, hi = (TANGENT_RATIO if rng.random() < 0.5
                          else (TANGENT_RATIO[1], 1.0))
                rj = round(ri * rng.uniform(lo, hi) * fk.R_QUANT) / fk.R_QUANT
                if rng.random() < 0.5:  # at the skip's edge
                    d = (ri + rj) * np.sqrt(float(edge)) * (
                        1.0 + rng.uniform(-ulps, ulps) * 2.0 ** -24)
                else:
                    d = (ri + rj) * (1.0 + rng.uniform(0.0, TANGENT_FAR))
            coords.append(center + d * pts[s])
            radii.append(rj)
        c += 1
    n = len(coords)
    m = -(-n // ATOM_TILE) * ATOM_TILE
    t = m // ATOM_TILE
    planes = np.zeros((fk.N_PLANES, m), np.float32)
    planes[0:3, :n] = np.asarray(coords, np.float32).T
    planes[3, :n] = np.asarray(radii, np.float32)
    planes[4, :n] = np.arange(1, n + 1, dtype=np.float32)
    jlist = np.zeros((t, fk.JLIST_ROWS), np.int64)
    jlist[:, 0] = t
    jlist[:, 1:1 + t] = (0xFFFF << 16) | np.arange(t)
    real = np.zeros(m, bool)
    real[:n] = True
    return planes, (jlist & 0xFFFFFFFF).astype(np.uint32).view(np.int32), real


def _popcount16(x):
    return sum((x >> g) & 1 for g in range(GROUPS_PER_TILE))


def streamed_groups(jlist, jmask_b=None):
    """[T] i64: admitted 8-atom groups each i-tile's lanes stream over its
    live entries, lane-weighted: with jmask_b, the mean of mask A's (in
    jlist) and mask B's groups, times two (so an integer)."""
    ent = jlist[:, 1:].to(torch.int64) & 0xFFFFFFFF
    live = torch.arange(ent.shape[1], device=ent.device) < jlist[:, 0:1]
    groups = _popcount16((ent >> 16) & 0xFFFF)
    if jmask_b is None:
        groups = 2 * groups
    else:
        groups = groups + _popcount16(jmask_b[:, 1:].to(torch.int64) & 0xFFFF)
    return (groups * live).sum(dim=1)


def timed(fn, device, reps):
    """(first-call ms, best warm ms of `reps` calls, last output) of
    fn().  The first call is timed on the host clock to a synchronize;
    warm calls with CUDA events on a card, on the host clock on the CPU."""
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    best = float("inf")
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            out = fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return first_ms, best, out


def graph_ms(fn, reps):
    """Mean device milliseconds of `fn()` over `reps` calls captured in one
    CUDA graph and replayed between two CUDA events, after a warm call:
    the host's enqueue of each call (allocations, checks, the launch),
    which `timed` counts where it outlasts a short kernel, stays out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def calls_ms(fn, reps):
    """Mean milliseconds of `reps` calls of `fn()` back to back between two
    CUDA events, after a warm call: the host's enqueue counts where it
    outlasts the card's work."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_variants(cases, real, atoms: int, device, reps: int):
    """Time each (name, fn) of `cases` with `timed`.  fn() returns counts
    [M] i32, or a tuple whose first item they are; the first case is
    kernel 1, whose counts the others are held against at the `real`
    slots.  Returns ({name: {"first_ms", "ms", "matoms_s", "max_dcount",
    "mean_dcount"}}, {name: fn()'s last output})."""
    variants, outs = {}, {}
    prod = None
    for name, fn in cases:
        first_ms, ms, out = timed(fn, device, reps)
        counts = out[0] if isinstance(out, tuple) else out
        if prod is None:
            prod = counts
        d = (counts.to(torch.int64) - prod.to(torch.int64)).abs()[real]
        variants[name] = {
            "first_ms": first_ms,
            "ms": ms,
            "matoms_s": atoms / (ms * 1e-3) / 1e6,
            "max_dcount": int(d.max()) if d.numel() else 0,
            "mean_dcount": float(d.double().mean()) if d.numel() else 0.0,
        }
        outs[name] = out
    return variants, outs


def k1_instructions(planes, jlist, sphere) -> int:
    """FP32 instructions kernel 1's counts of these inputs need
    (fused_kernel.needed_instructions of reach_work at the sphere's
    valid points): the work its rate is given at, since it streams only
    rows in reach."""
    work = fk.reach_work(planes, jlist, sphere)
    return fk.needed_instructions(work, int((sphere[:, 3] > 0).sum()))


def real_slots(offsets, m, device):
    """[m] bool: the slots that hold an atom (offsets entries (pos, n, _)
    as the packers return them; None for a structure they dropped)."""
    real = torch.zeros(m, dtype=torch.bool, device=device)
    for off in offsets:
        if off is not None:
            real[off[0]:off[0] + off[1]] = True
    return real


def synchronize(devices) -> None:
    """Wait for every CUDA device among `devices`."""
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def where(device) -> dict:
    """What a timing ran on: the host's `os.cpu_count()`, and for a CUDA
    `device` the card's `nvidia-smi` name and power limit."""
    from ..utils.card import nvidia_smi

    card = nvidia_smi() if torch.device(device).type == "cuda" else None
    return {"cpu_count": os.cpu_count(), "gpu_name": card and card[0],
            "power_limit": card and card[1]}


def where_line(info: dict) -> str:
    card = (f"{info['gpu_name']}, {info['power_limit']}"
            if info["gpu_name"] else "no card")
    return f"os.cpu_count() {info['cpu_count']}; {card}"


def device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


# neighbor_cases: the radii of the seeded clusters, and the offsets (A)
# whose clusters the cases move far from the origin, where the distance
# expansion's error is largest.
NEIGHBOR_RADII = BAND_RADII
NEIGHBOR_OFFSETS = (1000.0, -1000.0)


def _cluster(rng, n, side, offset=0.0):
    coords = (rng.uniform(0.0, side, (n, 3)) + offset).astype(np.float32)
    return coords, rng.choice(NEIGHBOR_RADII, n), np.arange(n, dtype=np.int32)


def cutoff_pairs(n_pairs: int, seed: int = 0, spread: float = 200.0,
                 ulps: int = 6):
    """(coords [2 n_pairs, 3] f32, radius, {pair: (d2, thr) ulps apart})
    of atom pairs whose distance expansion (neighbors._pair_d2, as the
    plain version and the kernel round it) lands next to the candidate
    cutoff thr = ((r + r) + 2 probe)^2 + 1e-3 of one radius r: j's
    coordinates stepped by up to `ulps` ulps on each axis from distance
    sqrt(thr), keeping d2 <= thr nearest to it for even pairs and d2 >
    thr nearest to it for odd ones."""
    from ..ops import neighbors

    rng = np.random.default_rng(seed)
    r = np.float32(1.8)
    cut = (r + r) + np.float32(2.0 * PROBE)
    thr = cut * cut + np.float32(neighbors._CUTOFF_SLACK)
    base = rng.uniform(-spread / 2, spread / 2, (n_pairs, 3)).astype(np.float32)
    u = rng.normal(size=(n_pairs, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    j0 = (base + u * np.sqrt(float(thr))).astype(np.float32)
    steps = np.arange(-ulps, ulps + 1, dtype=np.float32)
    grid = np.stack(np.meshgrid(steps, steps, steps, indexing="ij"),
                    -1).reshape(-1, 3)
    cand = (j0[:, None, :] + grid[None] * np.spacing(j0)[:, None, :]).astype(
        np.float32)  # [pairs, steps^3, 3]
    d2 = neighbors._pair_d2(torch.from_numpy(base[:, None, :]),
                            torch.from_numpy(cand)).numpy()
    coords = np.empty((2 * n_pairs, 3), np.float32)
    gap = {}
    for p in range(n_pairs):
        below = p % 2 == 0
        ok = d2[p] <= thr if below else d2[p] > thr
        at = np.flatnonzero(ok)[np.argmin(np.abs(d2[p][ok] - thr))]
        coords[2 * p] = base[p]
        coords[2 * p + 1] = cand[p, at]
        gap[p] = int(abs(np.int64(d2[p, at].view(np.int32))
                         - np.int64(thr.view(np.int32))))
    return coords, r, gap


def neighbor_case_names(offsets=NEIGHBOR_OFFSETS):
    """The names of neighbor_cases(offsets=offsets), in order."""
    return ("batch", "groups", *(f"offset {o:+g}" for o in offsets),
            "long_thin", "cutoff", "ball", "small")


def neighbor_cases(seed: int = 0, offsets=NEIGHBOR_OFFSETS):
    """Seeded list-path batches for the neighbor kernel and its plain
    version: [(name, packed [B, N, 4] f32, gid [B, N] i32, k)].

    batch: three structures (100, 700 and 1,000 atoms) in one 30 A box,
    padded to N = 1,024 (padding rows), one of them with two atoms
    sharing a group id; groups: 500 atoms in groups of four ids; offset
    o: a 600-atom cluster moved to o on every axis, for each o of
    `offsets`; long_thin: 2,000 atoms on a 4,000 A line through the
    origin; cutoff: pairs whose d2 lands next to the cutoff (cutoff_pairs),
    64 far from the origin and 64 near it, where d2 is within an ulp of
    it; ball: tests/test_torch_list_path.py's dense ball of 300 atoms,
    whose rows overflow K = 160 (the kept records are the K nearest);
    small: six structures of at most 8 atoms in N = 8 (K = 8; one
    128-atom tile holds them all).
    """
    from ..ops import engine

    rng = np.random.default_rng(seed)

    def one(coords, radius):
        n = coords.shape[0]
        return (coords, np.full(n, radius, np.float32),
                np.arange(n, dtype=np.int32))

    batch = [_cluster(rng, n, 30.0, 50.0) for n in (100, 700, 1000)]
    batch[1][2][7] = batch[1][2][3]
    coords, radii, _ = _cluster(rng, 500, 18.0, 40.0)
    groups = [(coords, radii, (np.arange(500) // 4).astype(np.int32))]
    offset = [(f"offset {off:+g}", [_cluster(rng, 600, 22.0, off)], 768, 160)
              for off in offsets]
    line = np.zeros((2000, 3), np.float32)
    line[:, 0] = np.linspace(-2000.0, 2000.0, 2000, dtype=np.float32)
    line[:, 1:] = rng.uniform(-1.5, 1.5, (2000, 2))
    long_thin = [(line, rng.choice(NEIGHBOR_RADII, 2000),
                  np.arange(2000, dtype=np.int32))]
    far, r, _ = cutoff_pairs(32, seed, spread=200.0)
    near, _, _ = cutoff_pairs(32, seed + 1, spread=4.0)
    ball = np.random.default_rng(0).normal(0, 2.5, (300, 3)).astype(
        np.float32)
    small = [_cluster(rng, int(m), 6.0) for m in rng.integers(1, 9, 6)]
    cases = [("batch", batch, 1024, 160), ("groups", groups, 512, 160),
             *offset, ("long_thin", long_thin, 2048, 64),
             ("cutoff", [one(np.concatenate([far, near]), r)], 128, 128),
             ("ball", [one(ball, 1.8)], 384, 160), ("small", small, 8, 16)]
    return [(name, *engine._pack(n_pad, structures), k)
            for name, structures, n_pad, k in cases]


ORDER_CASE_NAMES = ("shared_cells", "many_structures", "empty_structure",
                    "wide_span", "max_batch")


def order_cases():
    """Seeded batches for the cell ordering (neighbor_cells.cu's
    cell_keys) and its plain version: [(name, packed [B, N, 4] f32, gid
    [B, N] i32)], with ~30 % padding slots between the real atoms (none
    in shared_cells' one cell): shared_cells, 700 atoms in a 4 A box, 300
    of them at one point (one cell, kept in index order); many_structures,
    40 structures of N = 96; empty_structure, three of N = 200, the
    second with no real atom; wide_span, two of 300 atoms spread over
    +-1e6 A (the cell edge's widest grid, four 8-bit passes);
    max_batch, _kernels.MAX_CELL_BATCH structures of N = 8."""
    from ..ops import _kernels

    out = []
    shapes = {"shared_cells": (1, 700, 4.0), "many_structures": (40, 96, 30.0),
              "empty_structure": (3, 200, 30.0), "wide_span": (2, 300, 2e6),
              "max_batch": (_kernels.MAX_CELL_BATCH, 8, 15.0)}
    for name in ORDER_CASE_NAMES:
        b, n, spread = shapes[name]
        rng = np.random.default_rng(sum(map(ord, name)))
        packed = np.zeros((b, n, 4), np.float32)
        packed[..., :3] = rng.uniform(-spread / 2, spread / 2, (b, n, 3))
        packed[..., 3] = rng.choice(NEIGHBOR_RADII, (b, n))
        gid = np.tile(np.arange(n, dtype=np.int32), (b, 1))
        gid[rng.random((b, n)) < 0.3] = -1
        if name == "shared_cells":
            packed[0, 100:400, :3] = 1.0
            gid[0, 100:400] = np.arange(100, 400)
        if name == "empty_structure":
            gid[1] = -1
        if name == "wide_span":
            packed[:, 0, :3] = -spread / 2
            packed[:, 1, :3] = spread / 2
            gid[:, :2] = (0, 1)
        out.append((name, packed, gid))
    return out


def list_batch(path):
    """(packed [1, N, 4] f32, gid [1, N] i32, k) of one structure as the
    list path packs it: N its atom-count bucket, k its first K."""
    from ..ops import engine, neighbors

    coords, radii, gids = select(path)
    n_pad = neighbors._round_bucket(coords.shape[0], neighbors._N_BUCKETS)
    packed, gid = engine._pack(n_pad, [(coords, radii, gids)])
    return packed, gid, neighbors._initial_k(n_pad)


def record_multisets(planes, counts):
    """Each row's kept records as a set: [M, K, 4] i32 bit patterns of
    (vx, vy, vz, limit), the first min(count, K) slots of each row sorted
    (by vx, vy, vz, limit bits), the rest set to -1 (no f32 pattern the
    records take; the slots past a row's candidates are the kernel's
    own)."""
    k = planes.shape[1]
    m = counts.shape[0]
    bits = planes[:, :, :m].permute(2, 1, 0).contiguous().view(torch.int32)
    live = (torch.arange(k, device=planes.device)[None, :]
            < counts.to(torch.int64)[:, None])
    bits = torch.where(live[..., None], bits, -1).to(torch.int64)
    hi = (bits[..., 0] << 32) | (bits[..., 1] & 0xFFFFFFFF)
    lo = (bits[..., 2] << 32) | (bits[..., 3] & 0xFFFFFFFF)
    order = torch.sort(lo, dim=1, stable=True).indices
    order = order.gather(1, torch.sort(hi.gather(1, order), dim=1,
                                       stable=True).indices)
    return bits.to(torch.int32).gather(1, order[..., None].expand(-1, -1, 4))


def records_differ(got, want):
    """Where the neighbor kernel's (planes, counts, max_count) `got`
    differs from its plain version's `want`: [] when the counts and
    max_count are equal and every row keeps the same set of record bit
    patterns, with the kernel's slots past them and its padding columns
    (0, 0, 0, -1e30); else the parts that differ."""
    (gp, gc, gm), (wp, wc, wm) = got, want
    bad = []
    if not torch.equal(gc.to(torch.int64), wc.to(torch.int64)):
        bad.append(f"counts differ at {int((gc != wc).sum())} rows")
    if int(gm) != int(wm):
        bad.append(f"max_count {int(gm)} != {int(wm)}")
    if gp.shape != wp.shape:
        return bad + [f"planes {tuple(gp.shape)} != {tuple(wp.shape)}"]
    if not bad and not torch.equal(record_multisets(gp, gc),
                                   record_multisets(wp, wc)):
        bad.append("the rows' records differ")
    k, m = gp.shape[1], gc.shape[0]
    dead = (torch.arange(k, device=gp.device)[:, None]
            >= gc.to(torch.int64)[None, :])
    dead = torch.cat([dead, torch.ones((k, gp.shape[2] - m), dtype=torch.bool,
                                       device=gp.device)], dim=1)
    if bool((gp[:3][:, dead] != 0).any()) or bool(
            (gp[3][dead] != np.float32(-1e30)).any()):
        bad.append("slots past the candidates are not (0, 0, 0, -1e30)")
    return bad


def visited_pairs(keys, sorted_keys):
    """The atoms csrc/neighbor_cells.cu's scan visits for each row: those
    of the 27 cells around the row's own (itself included) -> [M] i64, 0
    for padding rows.  keys by atom and sorted, as neighbor_records makes
    them."""
    from ..ops import neighbors

    cm = neighbors.CELL_MAX
    real = keys != neighbors.PAD_KEY
    base = (keys >> 54) << 54
    cx, cy, cz = (keys >> 36) & cm, (keys >> 18) & cm, keys & cm
    z0 = (cz - 1).clamp(min=0)
    z1 = (cz + 1).clamp(max=cm)
    total = torch.zeros_like(keys)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            x, y = cx + dx, cy + dy
            ok = real & (x >= 0) & (x <= cm) & (y >= 0) & (y <= cm)
            col = base | (x.clamp(0, cm) << 36) | (y.clamp(0, cm) << 18)
            lo = torch.searchsorted(sorted_keys, col | z0)
            hi = torch.searchsorted(sorted_keys, col | z1, right=True)
            total += torch.where(ok, hi - lo, 0)
    return total
