"""Reach-test skips, 4-atom groups and bf16 in the count kernel, on the
card.

Port of the round-3 count-kernel study `scripts/r3_kernel_variants.py`:

    python -m rustsasa_tpu_torch.scripts.r3_kernel_variants [corpus_dir]

packs one host-cull f32 chunk (pack_structures) of up to 2,097,152 slots
and times kernel 1 (k1, which streams the groups of the host masks)
against csrc/reach_count.cu, which streams every live entry's whole
j-tile and lets a reach test on the staged rows, v2 - (r_i + r_j)^2 < 0
for some atom of the i-tile, decide what to compute:

  base         an 8-row group runs when some row of it is in reach;
  nogroupcond  everything runs (no test);
  jskip        base, and within a group only the rows in reach;
  group4       jskip over 4-row groups;
  nocond       base (the script's jskip without its per-row cond);
  bf16         base with the point-offset dot in bf16;
  bf16p        bf16 with the limit, margin and running max in bf16.

The f32 variants must give kernel 1's counts at every real slot; for
bf16 and bf16p it reports the largest and mean count difference.  Per
variant it also reports the j-atoms executed per atom against kernel 1's
streamed ones (the TPU study: ~36 % fewer executed blocks with jskip).
Without a corpus directory the repository's FreeSASA test structures
are cycled.
"""

from __future__ import annotations

import sys

import torch

from ..ops import _kernels, engine
from ..ops import fused_kernel as fk
from ..ops.fused_kernel import (
    ATOM_TILE, J_GROUP, JLIST_CAP, REFERENCE_BLOCK_ELEMS, _NEG_BIG,
)
from . import _study

VARIANTS = _kernels.REACH_VARIANTS
F32_VARIANTS = ("base", "nogroupcond", "jskip", "group4", "nocond")


def reach_counts_reference(planes, jlist, sphere, *, variant: str):
    """Plain-torch version of reach_counts -> (counts [M] i32, executed
    [T] i32).

    Entry by entry (j_tile = entry & 0xFFFF, mask bits ignored), every
    tile's 128 staged j-rows: v = c_i - c_j, v2 = (vx*vx + vy*vy) + vz*vz,
    kernel 1's limit and gid mask, and the reach test
    v2 - (r_i + r_j)^2 < 0 over all 128 i lanes.  The rows `variant`
    streams (see the module docstring) add their margins
    lim - (sx*vx + (sy*vy + sz*vz)) to the running max; bf16 rounds v and
    the sphere to bf16 and every operation of the dot (and in bf16p the
    limit, the margin and the max) as torch's bf16 ops do, except bf16's
    last add, which XLA does in f32 in the script.  executed sums
    the streamed rows, times the kernel's point passes.  Work is done in
    blocks of at most REFERENCE_BLOCK_ELEMS[device] (j, i, point) margins.
    """
    _kernels.variant_code("reach_counts", variant, VARIANTS)
    group = 4 if variant == "group4" else J_GROUP
    bf16 = variant in ("bf16", "bf16p")
    m = planes.shape[1]
    t = m // ATOM_TILE
    dev = planes.device
    p = sphere.shape[0]
    passes, _k = _kernels.point_passes(p)
    s = sphere[:, 0:3].to(torch.bfloat16) if bf16 else sphere[:, 0:3]
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]
    point_valid = sphere[:, 3] > 0.0

    n_ent = jlist[:, 0].to(torch.int64).clamp(0, JLIST_CAP)
    jtile = jlist[:, 1:].to(torch.int64) & 0xFFFF
    counts = torch.empty(m, dtype=torch.int32, device=dev)
    executed = torch.zeros(t, dtype=torch.int64, device=dev)
    lane = torch.arange(ATOM_TILE, device=dev)
    block = max(1, REFERENCE_BLOCK_ELEMS[dev.type] // (ATOM_TILE * ATOM_TILE * p))
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
        occ = torch.full((b, ATOM_TILE, p), _NEG_BIG, dtype=torch.float32,
                         device=dev)
        n_b = n_ent[t0:t1]
        for e in range(int(n_b.max()) if b else 0):
            jt = jtile[t0:t1, e]
            admit = (e < n_b) & (jt < t)  # [B]
            if not bool(admit.any()):
                continue
            atom = torch.where(admit, jt, 0)[:, None] * ATOM_TILE + lane
            xk, yk, zk, rk, gk = (
                planes[row][atom][:, :, None] for row in range(5)
            )  # [B, J, 1]
            vx = xi - xk  # [B, J, A]
            vy = yi - yk
            vz = zi - zk
            v2 = (vx * vx + vy * vy) + vz * vz
            lim = ((rk * rk - v2) - r2i) * inv2ri
            lim = torch.where((gk == gi) | (gk == 0.0), _NEG_BIG, lim)
            reach = ri + rk
            row_hit = ((v2 - reach * reach) < 0.0).any(dim=2)  # [B, J]
            group_hit = row_hit.reshape(b, -1, group).any(dim=2)
            if variant == "nogroupcond":
                streamed = torch.ones_like(row_hit)
            elif variant in ("jskip", "group4"):
                streamed = row_hit
            else:
                streamed = group_hit.repeat_interleave(group, dim=1)
            streamed = streamed & admit[:, None]
            executed[t0:t1] += streamed.sum(dim=1)
            if bf16:
                vx, vy, vz = (a.to(torch.bfloat16) for a in (vx, vy, vz))
            vx, vy, vz, lim = (a[..., None] for a in (vx, vy, vz, lim))
            if variant == "bf16":
                # XLA drops the round trip of the last bf16 add that the
                # script converts straight to f32: that add is in f32.
                dots = ((sx * vx).to(torch.float32)
                        + (sy * vy + sz * vz).to(torch.float32))
            else:
                dots = sx * vx + (sy * vy + sz * vz)  # [B, J, A, P]
            if variant == "bf16p":
                margin = (lim.to(torch.bfloat16) - dots).to(torch.float32)
            else:
                margin = lim - dots
            margin = torch.where(streamed[:, :, None, None], margin,
                                 float("-inf"))
            occ = torch.maximum(occ, margin.amax(dim=1))
        acc = (occ <= 0.0) & point_valid
        counts[sl] = acc.sum(dim=-1, dtype=torch.int32).reshape(-1)
    return counts, (passes * executed).to(torch.int32)


def reach_counts(planes, jlist, sphere, *, variant: str):
    """Occlusion counts [M] i32 and j-rows executed per tile [T] i32 under
    the reach test of `variant`; the plain version on the CPU,
    csrc/reach_count.cu on CUDA."""
    return fk.on_device(reach_counts_reference, _kernels.reach_count,
                        planes, jlist, sphere, variant=variant)


def run(triples, device, *, slots: int = _study.M_PAD, reps: int = 4,
        variants=VARIANTS):
    """The study on one host-cull f32 chunk of `slots` slots on `device`.

    Returns {"structures", "atoms", "slots", "tiles", "failed",
    "variants": {name: {"first_ms", "ms", "matoms_s", "max_dcount",
    "mean_dcount", "j_atoms_per_atom", "margins"}}} with k1 (kernel 1)
    first.  "j_atoms_per_atom" counts the j-atoms streamed per atom and
    point pass over the tiles with a non-empty j-list; "margins" the
    (j, i, point) margins a variant evaluates.
    """
    device = torch.device(device)
    planes, jl, real, n_atoms, tiles, failed = _study.host_cull_chunk(
        triples, device, slots
    )
    sphere = engine._sphere_device(_study.N_POINTS, device)
    passes, k = _kernels.point_passes(sphere.shape[0])
    points = passes * _kernels.SLICES * k
    cases = [("k1", lambda: fk.fused_counts(planes, jl, sphere))]
    cases += [(v, lambda v=v: reach_counts(planes, jl, sphere, variant=v))
              for v in variants]
    result, outs = _study.time_variants(cases, real, n_atoms, device, reps)
    busy = max(int((jl[:, 0] > 0).sum()), 1)
    for name, v in result.items():
        if name == "k1":
            j_atoms = int(_study.streamed_groups(jl).sum()) // 2 * J_GROUP
        else:
            j_atoms = int(outs[name][1].sum()) // passes
        v["j_atoms_per_atom"] = j_atoms / busy
        v["margins"] = j_atoms * ATOM_TILE * points
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
        rate = _study.INSTR_PER_MARGIN * v["margins"] / (v["ms"] * 1e-3)
        print(f"{name:11s} first {v['first_ms']:9.1f} ms  warm "
              f"{v['ms']:9.3f} ms ({v['ms'] / k1['ms']:.3f}x k1)  "
              f"{v['matoms_s']:7.2f} Matoms/s  {rate / 1e12:6.2f}T FP32 "
              f"instr/s at its own work  {v['j_atoms_per_atom']:7.1f} "
              f"j-atoms/atom executed  max|dc|={v['max_dcount']} "
              f"mean|dc|={v['mean_dcount']:.5f}", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("r3_kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    triples = _study.load_corpus(argv[0] if argv else None)
    result = run(triples, device)
    report(result, device, "r3_kernel_variants")
    return 0 if all(result["variants"][v]["max_dcount"] == 0
                    for v in F32_VARIANTS) else 1


if __name__ == "__main__":
    sys.exit(main())
