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
from ..ops.fused_kernel import ATOM_TILE, GROUPS_PER_TILE

PROBE = 1.4
N_POINTS = 100
M_PAD = 2_097_152
# The repository's FreeSASA test structures: the corpus when none is given.
TEST_STRUCTURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "data", "freesasa_pdbs",
)
STRUCTURE_SUFFIXES = (".pdb", ".cif", ".pdb.gz", ".cif.gz")
# FP32 instructions per margin: 3 mul, 2 add, 1 sub, 1 max.
INSTR_PER_MARGIN = 7


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


def real_slots(offsets, m, device):
    """[m] bool: the slots that hold an atom (offsets entries (pos, n, _)
    as the packers return them; None for a structure they dropped)."""
    real = torch.zeros(m, dtype=torch.bool, device=device)
    for off in offsets:
        if off is not None:
            real[off[0]:off[0] + off[1]] = True
    return real


def device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
