"""Round-4 sizing study: how much does finer i-side culling cut the stream?

The banded device cull admits a j-group when its AABB is in reach of any
of the i-tile's FOUR 32-atom sub-boxes.  This script counts streamed
j-atoms/atom on real corpus structures under coarser/finer i-side
granularities, plus the exact floors, to size the available win before
touching the kernel:

  tile128 : j-group vs whole i-tile AABB (round-2 behavior)
  sub32   : j-group vs 4x 32-atom i-sub-boxes (CURRENT production)
  sub8    : j-group vs 16x 8-atom i-groups (candidate change)
  exactg  : j-group admitted iff ANY j-atom within reach of ANY i-atom
            (the group-granularity floor - what perfect i-side culling
            could reach without changing the 8-atom j-group streaming)
  exacta  : true per-atom in-reach count (the reference's ~80-130/atom)
"""
import contextlib
import io
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..native import native_process_file
from ..ops.fused_kernel import (
    ATOM_TILE,
    GROUPS_PER_TILE,
    J_GROUP,
    _morton_codes,
)
from . import _study

CORPUS = None  # the corpus directory: run() sets it
PROBE = 1.4
SLACK = 0.01


def analyze(coords, radii):
    n = coords.shape[0]
    center = np.round(coords.mean(axis=0, dtype=np.float64) * 256.0) / 256.0
    c = coords - center.astype(np.float32)
    order = np.argsort(_morton_codes(c), kind="stable")
    c = c[order]
    r_eff = radii[order] + np.float32(PROBE)

    nt = -(-n // ATOM_TILE)
    slots = nt * ATOM_TILE
    big = np.float32(3e4)
    cmin = np.full((slots, 3), big, np.float32)
    cmin[:n] = c
    cmax = np.full((slots, 3), -big, np.float32)
    cmax[:n] = c
    rpad = np.zeros(slots, np.float32)
    rpad[:n] = r_eff
    ng = nt * GROUPS_PER_TILE
    gmin = cmin.reshape(ng, J_GROUP, 3).min(axis=1)
    gmax = cmax.reshape(ng, J_GROUP, 3).max(axis=1)
    gmaxr = rpad.reshape(ng, J_GROUP).max(axis=1)
    tmin = gmin.reshape(nt, GROUPS_PER_TILE, 3).min(axis=1)
    tmax = gmax.reshape(nt, GROUPS_PER_TILE, 3).max(axis=1)
    tmaxr = gmaxr.reshape(nt, GROUPS_PER_TILE).max(axis=1)
    smin = gmin.reshape(nt, 4, 4, 3).min(axis=2)  # 32-atom sub-boxes
    smax = gmax.reshape(nt, 4, 4, 3).max(axis=2)
    smaxr = gmaxr.reshape(nt, 4, 4).max(axis=2)

    def boxgap2(amin, amax, bmin, bmax):
        gap = np.maximum(np.maximum(amin - bmax, bmin - amax), 0.0)
        return (gap * gap).sum(axis=-1)

    atoms_per_tile = np.minimum(
        np.arange(1, nt + 1) * ATOM_TILE, n
    ) - np.arange(nt) * ATOM_TILE

    counts = {}
    # [nt, ng] tests: i-tile vs every j-group of the structure.
    # tile128
    g2 = boxgap2(tmin[:, None], tmax[:, None], gmin[None], gmax[None])
    reach = tmaxr[:, None] + gmaxr[None] + SLACK
    adm_t = g2 <= reach * reach
    counts["tile128"] = adm_t

    # sub32: any of the 4 sub-boxes reaches the j-group
    g2 = boxgap2(
        smin[:, :, None], smax[:, :, None], gmin[None, None], gmax[None, None]
    )  # [nt, 4, ng]
    reach = smaxr[:, :, None] + gmaxr[None, None] + SLACK
    counts["sub32"] = (g2 <= reach * reach).any(axis=1)

    # sub8: any of the 16 i-groups reaches the j-group
    ig_min = gmin.reshape(nt, GROUPS_PER_TILE, 3)
    ig_max = gmax.reshape(nt, GROUPS_PER_TILE, 3)
    ig_maxr = gmaxr.reshape(nt, GROUPS_PER_TILE)
    g2 = boxgap2(
        ig_min[:, :, None], ig_max[:, :, None],
        gmin[None, None], gmax[None, None],
    )  # [nt, 16, ng]
    reach = ig_maxr[:, :, None] + gmaxr[None, None] + SLACK
    counts["sub8"] = (g2 <= reach * reach).any(axis=1)

    # atombox: j-group admitted iff ANY i-ATOM (point + own r_eff) is
    # within reach of the j-group AABB (+ j-group max r).  Point-to-box
    # distances vectorize on device as one [M, band_groups] test - the
    # candidate middle ground between box-box and exact.
    cpad = np.zeros((slots, 3), np.float32)
    cpad[:n] = c
    gap = np.maximum(
        np.maximum(gmin[None, :, :] - cpad[:, None, :],
                   cpad[:, None, :] - gmax[None, :, :]),
        0.0,
    )  # [slots, ng, 3]
    pb2 = (gap * gap).sum(axis=-1)
    reach_pb = rpad[:, None] + gmaxr[None, :] + SLACK
    adm_atom = (pb2 <= reach_pb * reach_pb)  # [slots, ng]
    adm_atom[n:] = False
    counts["atombox"] = adm_atom.reshape(
        nt, ATOM_TILE, ng
    ).any(axis=1)

    # exact group floor + exact atom floor via per-atom distances
    # (O(n^2) but fine at ~2.6k atoms)
    d = np.linalg.norm(c[:, None, :] - c[None, :, :], axis=-1)
    reach_aa = r_eff[:, None] + r_eff[None, :]
    inreach = d <= reach_aa  # [n, n] true pair reach (incl. self)
    np.fill_diagonal(inreach, False)
    exacta = inreach.sum(axis=1)

    # group floor: j-group admitted for i-tile iff any (i-atom, j-atom)
    # pair in reach
    pad = np.zeros((slots, slots), bool)
    pad[:n, :n] = inreach
    per_tile_group = pad.reshape(
        nt, ATOM_TILE, ng, J_GROUP
    ).any(axis=(1, 3))  # [nt, ng]
    counts["exactg"] = per_tile_group

    out = {}
    for k, adm in counts.items():
        streamed = (adm.sum(axis=1) * J_GROUP * atoms_per_tile).sum()
        out[k] = streamed / n
    out["exacta"] = exacta.mean()
    return out


def main():
    files = sorted(os.listdir(CORPUS))[:60]
    pool = ThreadPoolExecutor(max_workers=4)

    def load(path):
        h = native_process_file(
            os.path.join(CORPUS, path), level="residue",
            include_hydrogens=False, include_hetatms=False,
            read_radii_from_occupancy=False, allow_vdw_fallback=False,
        )
        return h.coords.copy(), h.radii.copy()

    pairs = [p for p in pool.map(load, files) if p[0].shape[0] > 200]
    keys = ["tile128", "sub32", "sub8", "atombox", "exactg", "exacta"]
    totals = {k: 0.0 for k in keys}
    n_tot = 0
    for coords, radii in pairs:
        r = analyze(coords, radii)
        w = coords.shape[0]
        for k in keys:
            totals[k] += r[k] * w
        n_tot += w
    print(f"{len(pairs)} structures, {n_tot} atoms; streamed j-atoms/atom:")
    for k in keys:
        print(f"  {k:8s} {totals[k] / n_tot:8.1f}")



# The port's entry: the corpus as a parameter (the script's CORPUS) and
# main()'s lines as numbers.
#
#     python -m rustsasa_tpu_torch.scripts.r4_cull_granularity [corpus_dir]
#
# runs on the host (NumPy only) over the first 60 files of `corpus_dir`,
# else of the port's bench corpus (built under
# build/rustsasa_tpu_torch/bench/ when absent).
def run(corpus_dir=None) -> dict:
    """main() on `corpus_dir`; returns {"structures", "atoms",
    "streamed": {key: streamed j-atoms/atom}, "lines": main()'s lines}."""
    global CORPUS
    CORPUS = _study.bench_corpus(corpus_dir)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main()
    lines = out.getvalue().splitlines()
    structures, atoms = re.match(r"(\d+) structures, (\d+) atoms",
                                 lines[0]).groups()
    return {"structures": int(structures), "atoms": int(atoms),
            "streamed": {k: float(v) for k, v in map(str.split, lines[1:])},
            "lines": lines}


if __name__ == "__main__":
    for line in run(sys.argv[1] if len(sys.argv) > 1 else None)["lines"]:
        print(line)
