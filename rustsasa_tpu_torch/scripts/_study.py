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
                  ulps: float = 8.0, far: bool = False):
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
    d = (r_i + r_j) sqrt(fused_kernel.REACH_SLACK)(1 + t 2^-24), the rest
    at d = (r_i + r_j)(1 + t), t uniform in [0, TANGENT_FAR], across
    where the skip starts; the partners' radii as TANGENT_RATIO says, so
    the skip meets its worst radius ratio and pairs just past its guard.
    """
    from ..ops.sphere import sphere_points

    rng = np.random.default_rng(seed)
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
                    d = (ri + rj) * np.sqrt(float(fk.REACH_SLACK)) * (
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
