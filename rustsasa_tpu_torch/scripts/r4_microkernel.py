"""Loop micro-variants of the count kernel, on the card.

Port of the round-4 count-kernel study `scripts/r4_microkernel.py`:

    python -m rustsasa_tpu_torch.scripts.r4_microkernel [corpus_dir]

packs one host-cull f32 chunk (pack_structures: real group ids, j-lists
culled on the host) of up to 2,097,152 slots and times kernel 1 (k1)
against csrc/micro_count.cu in its five loop shapes:

  prod    one admitted 8-atom group per iteration (kernel 1's loop);
  split2  two running-max arrays (even and odd j-rows), merged at the end;
  g16     two admitted groups per iteration, g24 three (an odd tail
          repeats the last group);
  nosmem  all 16 groups of every entry, each limit offset by a gate of 0
          or -1e30 from the mask bit (no compaction).

All take the max of the same margins (nosmem adds ones at or below
-1e30), so the counts must equal kernel 1's exactly.  Per variant it
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


def micro_counts(planes, jlist, sphere, *, variant: str):
    """Occlusion counts [M] i32 through loop shape `variant`; the plain
    version on the CPU, csrc/micro_count.cu on CUDA."""
    return fk.on_device(micro_counts_reference, _kernels.micro_count,
                        planes, jlist, sphere, variant=variant)


def streamed_groups(jlist):
    """{variant: 8-atom groups each variant streams per point pass, summed
    over the chunk}: the admitted groups (prod, split2), rounded up to
    whole pairs (g16) or triples (g24), or all 16 of every live entry
    (nosmem)."""
    t = jlist.shape[0]
    ent = jlist[:, 1:].to(torch.int64) & 0xFFFFFFFF
    live = ((torch.arange(ent.shape[1], device=ent.device)
             < jlist[:, 0:1].clamp(0, fk.JLIST_CAP)) & ((ent & 0xFFFF) < t))
    n = _study._popcount16(ent >> 16) * live
    return {
        "prod": int(n.sum()), "split2": int(n.sum()),
        "g16": int(((n + 1) // 2 * 2).sum()),
        "g24": int(((n + 2) // 3 * 3).sum()),
        "nosmem": GROUPS_PER_TILE * int(live.sum()),
    }


def run(triples, device, *, slots: int = _study.M_PAD, reps: int = 4,
        variants=VARIANTS):
    """The study on one host-cull f32 chunk of `slots` slots on `device`.

    Returns {"structures", "atoms", "slots", "tiles", "failed",
    "variants": {name: {"first_ms", "ms", "matoms_s", "max_dcount",
    "mean_dcount", "groups", "margins"}}} with k1 (kernel 1) first, then
    each variant; "groups" counts the 8-atom groups a variant streams per
    point pass and "margins" its (j, i, point) margins.
    """
    device = torch.device(device)
    planes, jl, real, n_atoms, tiles, failed = _study.host_cull_chunk(
        triples, device, slots
    )
    sphere = engine._sphere_device(_study.N_POINTS, device)
    passes, k = _kernels.point_passes(sphere.shape[0])
    points = passes * _kernels.SLICES * k
    cases = [("k1", lambda: fk.fused_counts(planes, jl, sphere))]
    cases += [(v, lambda v=v: micro_counts(planes, jl, sphere, variant=v))
              for v in variants]
    result, _ = _study.time_variants(cases, real, n_atoms, device, reps)
    groups = streamed_groups(jl)
    groups["k1"] = groups["prod"]
    for name, v in result.items():
        v["groups"] = groups[name]
        v["margins"] = groups[name] * J_GROUP * ATOM_TILE * points
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
