"""Round-5 sizing: j-group bounding SPHERES vs AABBs for fine admission.

The banded builder admits a j-group when any i-ATOM's point-to-box gap
is within reach of the group AABB (+ its max radius).  Streamed j/atom
is 911 vs a 733 exact-group floor; the residual is bound-shape
conservatism.  This study counts admission under:
  atombox   : i-atom point vs j-group AABB (production)
  atomsphere: i-atom point vs j-group bounding sphere (Ritter-ish:
              center = coord mean, radius = max dist to center + max r)
  atomboth  : intersection of the two (sphere AND box must admit)

MEASURED (60 real structures, 162,600 atoms): atombox 911.4,
atomsphere 1060.5, atomboth 909.5 — spheres are LOOSER than AABBs for
Morton-grouped atoms (elongated groups inflate the radius), and the
intersection buys 0.2%.  Group-granularity admission is exhausted; the
remaining 911 -> 733 gap is the j-group bound vs true atom positions,
which only pair distances (i.e., the kernel work itself) could close.
"""
import contextlib
import io
import os, re, sys
import numpy as np
from concurrent.futures import ThreadPoolExecutor
from ..native import native_process_file
from ..ops.fused_kernel import ATOM_TILE, GROUPS_PER_TILE, J_GROUP, _morton_codes
from . import _study

CORPUS = None  # the corpus directory: run() sets it
PROBE = 1.4
SLACK = 0.01


def analyze(coords, radii):
    n = coords.shape[0]
    center = np.round(coords.mean(axis=0, dtype=np.float64) * 256.0) / 256.0
    c = (coords - center.astype(np.float32))
    order = np.argsort(_morton_codes(c), kind="stable")
    c = c[order]
    r_eff = radii[order] + np.float32(PROBE)
    nt = -(-n // ATOM_TILE)
    slots = nt * ATOM_TILE
    big = np.float32(3e4)
    cmin = np.full((slots, 3), big, np.float32); cmin[:n] = c
    cmax = np.full((slots, 3), -big, np.float32); cmax[:n] = c
    rpad = np.zeros(slots, np.float32); rpad[:n] = r_eff
    cpad = np.zeros((slots, 3), np.float32); cpad[:n] = c
    ng = nt * GROUPS_PER_TILE
    gmin = cmin.reshape(ng, J_GROUP, 3).min(axis=1)
    gmax = cmax.reshape(ng, J_GROUP, 3).max(axis=1)
    gmaxr = rpad.reshape(ng, J_GROUP).max(axis=1)
    # group bounding sphere over REAL members only
    memb = np.zeros(slots, bool); memb[:n] = True
    gm = memb.reshape(ng, J_GROUP)
    pts = cpad.reshape(ng, J_GROUP, 3)
    cnt = np.maximum(gm.sum(axis=1, keepdims=True), 1)
    ctr = (pts * gm[..., None]).sum(axis=1) / cnt
    d = np.linalg.norm(pts - ctr[:, None, :], axis=-1)
    d = np.where(gm, d, 0.0)
    grad = d.max(axis=1)  # sphere radius (geometry only)

    atoms_per_tile = np.minimum(np.arange(1, nt + 1) * ATOM_TILE, n) - np.arange(nt) * ATOM_TILE

    # point-to-box
    gap = np.maximum(np.maximum(gmin[None] - cpad[:, None], cpad[:, None] - gmax[None]), 0.0)
    pb2 = (gap * gap).sum(axis=-1)
    reach_pb = rpad[:, None] + gmaxr[None] + SLACK
    adm_box = pb2 <= reach_pb * reach_pb
    adm_box[n:] = False
    # point-to-sphere: dist(atom, ctr) - grad <= r_i + gmaxr + slack
    dc = np.linalg.norm(cpad[:, None, :] - ctr[None, :, :], axis=-1)
    adm_sph = (dc - grad[None, :]) <= (rpad[:, None] + gmaxr[None] + SLACK)
    adm_sph[n:] = False

    out = {}
    for k, adm in (("atombox", adm_box), ("atomsphere", adm_sph),
                   ("atomboth", adm_box & adm_sph)):
        per_tile = adm.reshape(nt, ATOM_TILE, ng).any(axis=1)
        out[k] = (per_tile.sum(axis=1) * J_GROUP * atoms_per_tile).sum() / n
    return out


def main():
    files = sorted(os.listdir(CORPUS))[:60]
    pool = ThreadPoolExecutor(max_workers=4)

    def load(p):
        h = native_process_file(os.path.join(CORPUS, p), level="residue",
            include_hydrogens=False, include_hetatms=False,
            read_radii_from_occupancy=False, allow_vdw_fallback=False)
        return h.coords.copy(), h.radii.copy()

    pairs = [p for p in pool.map(load, files) if p[0].shape[0] > 200]
    keys = ["atombox", "atomsphere", "atomboth"]
    totals = {k: 0.0 for k in keys}; n_tot = 0
    for coords, radii in pairs:
        r = analyze(coords, radii)
        w = coords.shape[0]
        for k in keys: totals[k] += r[k] * w
        n_tot += w
    print(f"{len(pairs)} structures, {n_tot} atoms; streamed j/atom:")
    for k in keys:
        print(f"  {k:10s} {totals[k] / n_tot:8.1f}")



# The port's entry: the corpus as a parameter (the script's CORPUS) and
# main()'s lines as numbers.
#
#     python -m rustsasa_tpu_torch.scripts.r5_spherecull [corpus_dir]
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
