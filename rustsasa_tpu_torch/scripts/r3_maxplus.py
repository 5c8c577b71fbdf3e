"""The max-plus form of the count kernel, on the card.

Port of the round-3 count-kernel study `scripts/r3_maxplus.py`:

    python -m rustsasa_tpu_torch.scripts.r3_maxplus [corpus_dir]

packs one banded q16 chunk of up to 2,097,152 slots (structures of at
most W = 32 tiles), builds build_jlist_banded's j-lists on the device and
times kernel 1 (prod) against csrc/maxplus_count.cu (mp_static), which
takes kernel 1's margin as

    (LIMT[j, i] + TJ[p, j]) - SXI[p, i],   SXI = s.c_i,  TJ = s.c_j,

so that SXI leaves the max over j and each margin costs an add and a max
(kernel 1: 7 FP32 instructions).  The K = 3 products round as XLA-CPU's
dot does (a fused multiply-add chain), so boundary points may flip
against kernel 1: the study reports the largest and mean count
difference at real slots, the milliseconds and the FP32 instruction
rate at each kernel's own work.  The script's docstring also names an
`mp_rot` variant; the script holds no kernel for it.  Without a corpus
directory the repository's FreeSASA test structures are cycled.
"""

from __future__ import annotations

import sys

import torch

from ..ops import _kernels, engine
from ..ops.fma import dot3
from ..ops import fused_kernel as fk
from ..ops.fused_kernel import (
    ATOM_TILE, JLIST_CAP, J_GROUP, REFERENCE_BLOCK_ELEMS, _NEG_BIG,
)
from . import _study

W = 32
# Count flips per atom allowed against kernel 1 (__graft_entry__.py's
# bound for a reordered f32 margin).
MAX_FLIPS = 2
# FP32 instructions per margin of the max-plus kernel: add, max.
MAXPLUS_INSTR_PER_MARGIN = 2


def maxplus_counts_reference(planes, jlist, sphere):
    """Plain-torch version of maxplus_counts: [N_PLANES, M] planes -> [M]
    i32.

    Per i-tile, SXI[p, i] = dot3(s, c_i) and ci2 = dot3(c_i, c_i); per
    admitted j-atom (kernel 1's j-list entries and group masks),
    cji = dot3(c_j, c_i), v2t = (cj2 - 2*cji) + ci2,
    LIMT = ((r_j*r_j - v2t) - r_i*r_i) * (0.5 / max(r_i, 1e-6)) (-1e30
    where gid_j == gid_i or gid_j == 0) and TJ[p, j] = dot3(s, c_j).  A
    valid point is accessible when max_j (LIMT + TJ) - SXI <= 0.  Work is
    done in blocks of at most REFERENCE_BLOCK_ELEMS[device] margins.
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
        jidx, jv = fk.admitted_atoms(ent[t0:t1], live[t0:t1])
        n_j = jidx.shape[1]
        xk, yk, zk, rk, gk = (planes[row][jidx] for row in range(5))

        sl = slice(t0 * ATOM_TILE, t1 * ATOM_TILE)
        xi, yi, zi, ri, gi = (
            planes[row, sl].reshape(b, 1, ATOM_TILE) for row in range(5)
        )
        r2i = ri * ri
        # Tensor / tensor: `0.5 / x` would run as reciprocal(x) * 0.5.
        inv2ri = torch.full_like(ri, 0.5) / torch.clamp_min(ri, 1e-6)
        ci2 = dot3(xi, xi, yi, yi, zi, zi)  # [B, 1, A]
        sxi = dot3(sx, xi[..., None], sy, yi[..., None], sz,
                   zi[..., None]).reshape(b, ATOM_TILE, p)
        occ = torch.full((b, ATOM_TILE, p), _NEG_BIG, dtype=torch.float32,
                         device=dev)
        jc = max(1, block_elems // (b * ATOM_TILE * p))
        for j0 in range(0, n_j, jc):
            js = slice(j0, j0 + jc)
            xj, yj, zj = xk[:, js, None], yk[:, js, None], zk[:, js, None]
            cj2 = dot3(xj, xj, yj, yj, zj, zj)  # [B, Jc, 1]
            cji = dot3(xj, xi, yj, yi, zj, zi)  # [B, Jc, A]
            v2t = (cj2 - 2.0 * cji) + ci2
            rkk = rk[:, js, None]
            limt = ((rkk * rkk - v2t) - r2i) * inv2ri
            gkk = gk[:, js, None]
            limt = torch.where((gkk == gi) | (gkk == 0.0), _NEG_BIG, limt)
            # Padding of the admitted list holds no j-atom: no margin.
            limt = torch.where(jv[:, js, None], limt, float("-inf"))
            tj = dot3(sx, xj, sy, yj, sz, zj)  # [B, Jc, P]
            margins = limt[..., None] + tj[:, :, None, :]  # [B, Jc, A, P]
            occ = torch.maximum(occ, margins.amax(dim=1))
        acc = ((occ - sxi) <= 0.0) & point_valid
        out[sl] = acc.sum(dim=-1, dtype=torch.int32).reshape(-1)
    return out


def maxplus_counts(planes, jlist, sphere):
    """Occlusion counts [M] i32 in the max-plus form; the plain version on
    the CPU, csrc/maxplus_count.cu on CUDA."""
    return fk.on_device(maxplus_counts_reference, _kernels.maxplus_count,
                        planes, jlist, sphere)


def run(triples, device, *, w: int = W, slots: int = _study.M_PAD,
        reps: int = 4):
    """The study on one banded q16 chunk of `slots` slots on `device`.

    Returns {"structures", "atoms", "slots", "tiles", "build_ms",
    "variants": {name: {"first_ms", "ms", "matoms_s", "max_dcount",
    "mean_dcount", "margins", "instr_per_margin", "instr"}}} with
    variants prod (kernel 1) and mp_static; "margins" counts the (j, i,
    point) margins of the admitted groups, "instr" the FP32 instructions
    of each one's work: instr_per_margin a margin for mp_static, and for
    prod, which streams only rows in reach, what these inputs need
    (_study.k1_instructions).
    """
    device = torch.device(device)
    planes, qvalid, tmeta, real, n_atoms, tiles = _study.banded_chunk(
        triples, device, slots
    )
    sphere = engine._sphere_device(_study.N_POINTS, device)
    _first, build_ms, jlist = _study.timed(
        lambda: fk.build_jlist_banded(planes, qvalid, tmeta, w=w), device, reps
    )
    result, _ = _study.time_variants((
        ("prod", lambda: fk.fused_counts(planes, jlist, sphere)),
        ("mp_static", lambda: maxplus_counts(planes, jlist, sphere)),
    ), real, n_atoms, device, reps)
    passes, k = _kernels.point_passes(sphere.shape[0])
    margins = (int(_study.streamed_groups(jlist).sum()) // 2 * J_GROUP
               * ATOM_TILE * passes * _kernels.SLICES * k)
    for name, per in (("prod", _study.INSTR_PER_MARGIN),
                      ("mp_static", MAXPLUS_INSTR_PER_MARGIN)):
        result[name]["margins"] = margins
        result[name]["instr_per_margin"] = per
        result[name]["instr"] = per * margins
    result["prod"]["instr"] = _study.k1_instructions(planes, jlist, sphere)
    return {
        "structures": len(triples), "atoms": n_atoms, "slots": slots,
        "tiles": tiles, "build_ms": build_ms, "variants": result,
    }


def report(result, device, head: str) -> None:
    print(f"{head}: {result['structures']} structures, {result['atoms']} "
          f"atoms, {result['tiles']} tiles in M={result['slots']} slots on "
          f"{_study.device_name(device)}; build_jlist_banded "
          f"{result['build_ms']:.3f} ms", flush=True)
    prod = result["variants"]["prod"]
    for name, v in result["variants"].items():
        rate = v["instr"] / (v["ms"] * 1e-3)
        print(f"{name:9s} first {v['first_ms']:9.1f} ms  warm {v['ms']:9.3f} "
              f"ms ({v['ms'] / prod['ms']:.3f}x prod)  {v['matoms_s']:7.2f} "
              f"Matoms/s  {rate / 1e12:6.2f}T FP32 instr/s at its own work "
              f"({v['instr'] / v['margins']:.3f} per admitted margin)  max|dc|="
              f"{v['max_dcount']} mean|dc|={v['mean_dcount']:.5f}",
              flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("r3_maxplus: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    triples = _study.load_corpus(argv[0] if argv else None, max_tiles=W)
    result = run(triples, device)
    report(result, device, "r3_maxplus")
    return 0 if result["variants"]["mp_static"]["max_dcount"] <= MAX_FLIPS else 1


if __name__ == "__main__":
    sys.exit(main())
