"""The host-device link of this deployment: the dispatch floor, the copy
rates both ways, and one small protein end to end.

Port of `scripts/r3_link_floor.py`:

    python -m rustsasa_tpu_torch.scripts.r3_link_floor [--device cuda|cpu]

Every timing ends with a readback to the host, on the host clock, as
the reference's do:

  dispatch floor : a trivial op on an 8-float tensor on the device and
                   its `.cpu()` readback, 30 warm calls (median, min);
  h2d / d2h      : 16 and 64 MB (2^20 bytes) of f32 to and from the
                   device, from pageable host memory (the reference's
                   `_mbps` keys) and from pinned memory (`_pinned_mbps`,
                   the memory the engine copies through), each the
                   median of 5 copies after one drain; on the CPU the
                   copies are host copies and no memory is pinned (None);
  fused single   : the reference's seeded 2,622-atom structure (uniform
                   in a 40 A cube, radius 1.7) on the banded q16 wire at
                   w = 32, padded to the reference engine's bucket
                   (4,096 slots): each call copies the wire from fresh
                   pinned memory, runs `fused_sasa_q16_banded`
                   (dequant_boxes, band_jlist, fused_count) and reads
                   the counts back; the median of 10 after a first call.

The JSON line has the reference's keys (`dispatch_floor_median_ms`,
`dispatch_floor_min_ms`, `h2d_{16,64}mb_mbps`, `d2h_{16,64}mb_mbps`,
`fused_single_protein_device_median_ms`), the pinned rates beside them,
and the card's name and power limit (`utils/card.py`).  The numbers are
left unrounded.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..ops import engine, fused_kernel as fk
from . import _study
from .profile_fused import FUSED_M_BUCKETS

FLOOR_REPS = 30
COPY_MB = (16, 64)
COPY_REPS = 5
FUSED_REPS = 10
# The reference's single protein and its call.
SINGLE_ATOMS = 2622
SINGLE_SIDE = 40.0
SINGLE_RADIUS = 1.7
N_POINTS = 100
W = 32


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dispatch_floor(device, reps: int = FLOOR_REPS) -> list[float]:
    """Seconds of each warm trivial op + readback, sorted."""
    x = torch.zeros(8, dtype=torch.float32, device=device)
    (x + 1.0).cpu()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        (x + 1.0).cpu()
        times.append(time.perf_counter() - t0)
    return sorted(times)


def copy_rates(buf: np.ndarray, device, pinned: bool,
               reps: int = COPY_REPS) -> tuple[float, float]:
    """(h2d, d2h) MB/s (2^20 bytes) of `buf` to `device` and back, each
    the median of `reps` copies synced by a readback."""
    mb = buf.nbytes / 2**20
    host = torch.from_numpy(buf)
    if pinned:
        host = host.pin_memory()
    back = torch.empty_like(host, pin_memory=pinned)
    h2d, d2h = [], []
    d = host.to(device, copy=True, non_blocking=pinned)
    d[:8].cpu()  # drain
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        d = host.to(device, copy=True, non_blocking=pinned)
        d[:8].cpu()  # the copy is queued before this readback
        h2d.append(time.perf_counter() - t0)
        _sync(device)
        t0 = time.perf_counter()
        back.copy_(d, non_blocking=pinned)
        _sync(device)
        d2h.append(time.perf_counter() - t0)
    return mb / statistics.median(h2d), mb / statistics.median(d2h)


def single_protein_wire(rng):
    """The reference's 2,622-atom structure on the banded q16 wire,
    padded to its engine's bucket: (planes4, tparams, tmeta, slots)."""
    coords = (rng.random((SINGLE_ATOMS, 3)) * SINGLE_SIDE).astype(np.float32)
    radii = np.full(SINGLE_ATOMS, SINGLE_RADIUS, np.float32)
    gids = np.arange(SINGLE_ATOMS, dtype=np.int32)
    planes4, tparams, tmeta, _offsets = fk.pack_structures_q16(
        [(coords, radii, gids)], 1.4)
    m = planes4.shape[1]
    m_pad = next(b for b in FUSED_M_BUCKETS if b >= m)
    pad_t = (m_pad - m) // fk.ATOM_TILE
    return (np.pad(planes4, ((0, 0), (0, m_pad - m))),
            np.pad(tparams, ((0, pad_t), (0, 0))),
            np.pad(tmeta, ((0, pad_t), (0, 0))), m_pad)


def run(device="cuda", *, floor_reps: int = FLOOR_REPS,
        copy_reps: int = COPY_REPS, fused_reps: int = FUSED_REPS,
        say=lambda line: None) -> dict:
    """The measurements of the module docstring; `say` takes each line.
    Returns the JSON record (the reference's keys, the pinned rates,
    `trivial_first_s`, `fused_first_s`, `fused_single_protein_device_
    min_ms`, `single_slots`, the counts' sum `single_counts_sum`, and
    cpu_count, gpu_name, power_limit)."""
    dev = engine.resolve_devices(device)[0]
    out = {}
    t0 = time.perf_counter()
    (torch.zeros(8, device=dev) + 1.0).cpu()
    out["trivial_first_s"] = time.perf_counter() - t0
    times = dispatch_floor(dev, floor_reps)
    out["dispatch_floor_median_ms"] = statistics.median(times) * 1e3
    out["dispatch_floor_min_ms"] = times[0] * 1e3
    say(f"dispatch floor (trivial op + readback): median "
        f"{out['dispatch_floor_median_ms']:.4f}ms min "
        f"{out['dispatch_floor_min_ms']:.4f}ms")

    # One generator, drawn in the reference's order: the copy buffers,
    # then the structure.
    rng = np.random.default_rng(0)
    for mb in COPY_MB:
        buf = rng.random((mb * 1024 * 1024 // 4,)).astype(np.float32)
        h2d, d2h = copy_rates(buf, dev, False, copy_reps)
        out[f"h2d_{mb}mb_mbps"], out[f"d2h_{mb}mb_mbps"] = h2d, d2h
        pinned = (copy_rates(buf, dev, True, copy_reps)
                  if dev.type == "cuda" else (None, None))
        out[f"h2d_{mb}mb_pinned_mbps"] = pinned[0]
        out[f"d2h_{mb}mb_pinned_mbps"] = pinned[1]
        say(f"{mb:4d}MB  pageable h2d {h2d:9.1f} MB/s  d2h {d2h:9.1f} MB/s"
            + (f"   pinned h2d {pinned[0]:9.1f} MB/s  d2h {pinned[1]:9.1f}"
               " MB/s" if pinned[0] is not None else ""))

    wire = single_protein_wire(rng)
    *arrays, m_pad = wire
    sphere = engine._sphere_device(N_POINTS, dev)

    def call():
        planes4, tparams, tmeta = fk.to_device(
            [a.copy() for a in arrays], dev)
        return fk.fused_sasa_q16_banded(planes4, tparams, tmeta, sphere,
                                        n_points=N_POINTS, w=W).cpu()

    t0 = time.perf_counter()
    counts = call()
    out["fused_first_s"] = time.perf_counter() - t0
    times = []
    for _ in range(fused_reps):
        t0 = time.perf_counter()
        counts = call()
        times.append(time.perf_counter() - t0)
    out["fused_single_protein_device_median_ms"] = (
        statistics.median(times) * 1e3)
    out["fused_single_protein_device_min_ms"] = min(times) * 1e3
    out["single_slots"] = m_pad
    out["single_counts_sum"] = int(counts.to(torch.int64).sum())
    say(f"fused banded first call (M={m_pad}): {out['fused_first_s']:.3f}s")
    say(f"fused banded warm ({SINGLE_ATOMS} atoms, M={m_pad}): median "
        f"{out['fused_single_protein_device_median_ms']:.4f}ms min "
        f"{out['fused_single_protein_device_min_ms']:.4f}ms")
    out.update(_study.where(dev))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    result = run(args.device, say=lambda s: print(s, flush=True))
    print(_study.where_line(result), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
