"""Per-i-atom fine culling in the banded j-list builder, on the card.

Port of the round-4 study `scripts/r4_atombox.py`:

    python -m rustsasa_tpu_torch.scripts.r4_atombox [corpus_dir] \\
        [--device cuda|cpu]

The script's builder, `build_jlist_atombox`, admits a j-group into an
i-tile's j-list when some i-atom (its point plus its own r_eff) reaches
the group's box (`any(pb2 <= rr*rr)` over the tile's atoms), behind the
same tile-pair box test as the production builder.  Both are plain
torch here, as they are XLA code in the reference.  On one q16 chunk of
the corpus's first 900 files (the port's bench corpus, built under
build/rustsasa_tpu_torch/bench/ when absent), padded to 2,097,152 slots
at band width w = 32, it times per row:

  build         : q16 dequant, then the row's builder (`build_only`);
  build+kernel  : the same, then kernel 1 (`full`, u8 counts);

and reports Matoms/s of `full`, the 8-atom-group j-atoms each tile's
lanes stream (mean over all tiles, padding included) and the largest
count difference to the first row.  Timings are the best of four calls
between two CUDA events after one warm call.

The row the script labels "sub32" calls the production builder, here its
plain version `build_jlist_banded_reference`.  Since round 4 that builder
holds the same per-i-atom stage, reduced as a float max (`max(rr*rr -
pb2) >= 0`), which admits exactly the same groups; so both rows give
byte-equal j-lists and counts, and the study measures the two
reductions' cost in plain torch.  A third row, "kernel", times the
production builder as the main path runs it on the card (the
`band_jlist` kernel, plain torch on the CPU); it gives the same j-lists
again.  Every row dequantizes with `dequant_boxes_q16` (the
`dequant_boxes` kernel on the card); only "kernel" reads its boxes.  As
in the script, a structure of more than w tiles keeps only its tile
pairs within w - 1 of each other, in every row alike (none in the bench
corpus's first 900 files has more than 29 tiles).

`ATOMBOX_BLK` (environment, or `blk=`) keeps its meaning: the shifts
(2w - 1 = 63) whose [T, 16, 128, 3] gap tensors are computed at once; 1
(the default) is one shift at a time, at least 2w - 1 all at once.  At
T = 16,384 one shift's f32 gap tensor is 0.4 GB, so all 63 at once would
need about 25 GB per intermediate.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import fused_kernel as fk
from ..ops.fused_kernel import (
    ATOM_TILE, DEVICE_CULL_SLACK, GROUPS_PER_TILE, J_GROUP, _sum3,
    compact_rows, group_mask,
)
from . import _study

M_PAD = 2_097_152
W = 32
FILES = 900
N_POINTS = 100
ROWS = ("sub32", "atombox", "kernel")


def build_jlist_atombox(planes, qvalid, tmeta, *, w: int, blk=None):
    """The banded builder with the script's fine stage: i-atoms against
    the shifted j-group boxes, a group admitted iff any i-atom reaches
    it -> [T, JLIST_ROWS] i32 j-lists.  `blk` shifts at a time (default
    the ATOMBOX_BLK environment variable, else 1)."""
    if blk is None:
        blk = int(os.environ.get("ATOMBOX_BLK", "1"))
    j, act, sep2, c_t, r_t, (gmin_p, gmax_p, gmaxr_p) = fk.band_boxes(
        planes, qvalid, tmeta, w=w)
    nd, t = act.shape

    def shifted(x, ds):
        """Offsets ds's windows of a padded box tensor: [len(ds), T, ...]."""
        return torch.stack([x[d:d + t] for d in ds])

    # [b, T, 16, A] point-to-box admission for a block of b shifts,
    # reduced over the tile's atoms with any().
    ci = c_t[:, None, :, :]  # [T, 1, A, 3]
    bits = torch.empty((nd, t, GROUPS_PER_TILE), dtype=torch.bool,
                       device=planes.device)
    step = 1 if blk <= 1 else min(blk, nd)
    for d0 in range(0, nd, step):
        ds = range(d0, min(d0 + step, nd))
        mn = shifted(gmin_p, ds)[:, :, :, None, :]  # [b, T, 16, 1, 3]
        mx = shifted(gmax_p, ds)[:, :, :, None, :]
        g = torch.clamp_min(torch.maximum(mn - ci, ci - mx), 0.0)
        pb2 = _sum3(g * g)  # [b, T, 16, A]
        rr = (r_t[:, None, :] + shifted(gmaxr_p, ds)[..., None]
              + DEVICE_CULL_SLACK)
        bits[d0:d0 + step] = (pb2 <= rr * rr).any(dim=-1)
    mask = group_mask(bits)  # [nd, T]
    act = act & (mask > 0)
    return compact_rows(act, sep2, (mask << 16) | j)[0]


def build_only(planes4, tparams, tmeta, *, w: int, fine: str, blk=None):
    """q16 dequant, then the `fine` row's builder (one of ROWS) ->
    (jlist, planes)."""
    planes, qvalid, boxes = fk.dequant_boxes_q16(planes4, tparams)
    if fine == "atombox":
        return build_jlist_atombox(planes, qvalid, tmeta, w=w, blk=blk), planes
    if fine == "kernel":
        return fk.build_jlist_banded(planes, qvalid, tmeta, w=w,
                                     boxes=boxes), planes
    return fk.build_jlist_banded_reference(planes, qvalid, tmeta, w=w), planes


def full(planes4, tparams, tmeta, sphere, *, n_points: int, w: int,
         fine: str, blk=None):
    """build_only, then kernel 1 -> per-slot counts (u8 up to 255
    points)."""
    jlist, planes = build_only(planes4, tparams, tmeta, w=w, fine=fine,
                               blk=blk)
    return fk._counts_out(fk.fused_counts(planes, jlist, sphere), n_points)


def load_chunk(corpus_dir=None, device="cuda", *, files: int = FILES,
               slots: int = M_PAD):
    """pack_structures_q16's wire of the first `files` corpus files,
    zero-padded to `slots` slots, on `device` -> (planes4, tparams,
    tmeta, real [slots] bool, atoms, structures)."""
    paths = _study.corpus_files(corpus_dir)[:files]
    with ThreadPoolExecutor(max_workers=4) as pool:
        triples = list(pool.map(_study.select, paths))
    planes4, tparams, tmeta, offsets = fk.pack_structures_q16(triples,
                                                              _study.PROBE)
    m = planes4.shape[1]
    if m > slots:
        raise ValueError(f"{m} slots packed, more than {slots}")
    pad_t = (slots - m) // ATOM_TILE
    wire = fk.to_device((
        np.pad(planes4, ((0, 0), (0, slots - m))),
        np.pad(tparams, ((0, pad_t), (0, 0))),
        np.pad(tmeta, ((0, pad_t), (0, 0))),
    ), device)
    atoms = sum(t[0].shape[0] for t in triples)
    return (*wire, _study.real_slots(offsets, slots, device), atoms,
            len(triples))


def streamed_per_tile_atom(jlist) -> float:
    """The 8-atom-group j-atoms an i-tile's lanes stream over its live
    entries, averaged over every tile of the chunk."""
    groups = _study.streamed_groups(jlist) // 2
    return float((groups * J_GROUP).double().mean())


def run(corpus_dir=None, device="cuda", *, files: int = FILES,
        slots: int = M_PAD, w: int = W, reps: int = 4, blk=None) -> dict:
    """The study on one chunk; returns {"structures", "atoms", "slots",
    "w", "rows": {row: {"build_ms", "full_ms", "matoms_s", "streamed",
    "max_dcount"}}, "jlists_equal", "counts_equal"} and where it ran
    (cpu_count, gpu_name, power_limit).  jlists_equal / counts_equal:
    every row's j-lists are byte-equal to the first's, and its counts at
    every real slot."""
    from ..ops import engine

    dev = engine.resolve_devices(device)[0]
    planes4, tparams, tmeta, real, atoms, n = load_chunk(
        corpus_dir, dev, files=files, slots=slots)
    sphere = engine._sphere_device(N_POINTS, dev)

    rows, jlists, counts = {}, {}, {}
    for fine in ROWS:
        kw = {"w": w, "fine": fine, "blk": blk}
        _, build_ms, (jlists[fine], _) = _study.timed(
            lambda: build_only(planes4, tparams, tmeta, **kw), dev, reps)
        _, full_ms, counts[fine] = _study.timed(
            lambda: full(planes4, tparams, tmeta, sphere, n_points=N_POINTS,
                         **kw), dev, reps)
        d = (counts[fine].to(torch.int64)
             - counts[ROWS[0]].to(torch.int64)).abs()[real]
        rows[fine] = {
            "build_ms": build_ms, "full_ms": full_ms,
            "matoms_s": atoms / (full_ms * 1e-3) / 1e6,
            "streamed": streamed_per_tile_atom(jlists[fine]),
            "max_dcount": int(d.max()) if d.numel() else 0,
        }
    a = ROWS[0]
    return {
        "structures": n, "atoms": atoms, "slots": slots, "w": w,
        "rows": rows,
        "jlists_equal": all(torch.equal(jlists[a], jlists[b]) for b in ROWS),
        "counts_equal": all(torch.equal(counts[a][real], counts[b][real])
                            for b in ROWS),
        **_study.where(dev),
    }


def lines(r: dict) -> list[str]:
    """The script's lines for a run() result, then where it ran."""
    out = [f"{r['structures']} files, {r['atoms']} atoms, M={r['slots']}"]
    for fine, v in r["rows"].items():
        out.append(
            f"{fine:8s} build {v['build_ms']:7.1f}ms  build+kernel "
            f"{v['full_ms']:7.1f}ms  {v['matoms_s']:5.2f} Matoms/s  "
            f"streamed/tile-atom ~{v['streamed']:6.0f}  "
            f"max|dc|={v['max_dcount']:.0f}")
    out.append(f"j-lists byte-equal: {r['jlists_equal']}; counts "
               f"byte-equal at real slots: {r['counts_equal']}")
    out.append(_study.where_line(r))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("corpus_dir", nargs="?", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    result = run(args.corpus_dir, args.device)
    for line in lines(result):
        print(line, flush=True)
    return 0 if result["jlists_equal"] and result["counts_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
