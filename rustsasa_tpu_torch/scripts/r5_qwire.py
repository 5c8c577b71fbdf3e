"""The 12-bit wire (6 B per atom slot) against the q16 wire, on the card.

Port of the round-5 study `scripts/r5_qwire.py`:

    python -m rustsasa_tpu_torch.scripts.r5_qwire [corpus_dir] \\
        [--device cuda|cpu]

The script's candidate format, specified by its numpy packer `pack_q12`
(copied as written, per-atom palette loop included):

  wire_a u32[M]: qx(12) | qy(12) | qz_hi(8)
  wire_b u16[M]: qz_lo(4) | radius palette index(8) | spare(4)
  palette f32[256]: the chunk's exact r_eff values, palette[0] = 0 for
  padding slots, so the dequantized radii are bit-equal to the f32 path's

with coordinates quantized to 12 bits against each structure's box
(structures over 100 A make it return None).  `fused_sasa_q12_banded`
dequantizes it in torch (the script's XLA code), then runs the
production banded cull and kernel 1.

`run` selects the corpus's structures of at most 32 tiles in name order
(the port's bench corpus, built under build/rustsasa_tpu_torch/bench/
when absent) until the next would overflow 2,097,152 slots, packs them
both ways and times each route from numpy arrays on the host to counts
back on the host, the copies to the card included, as the pipeline pays
them: the best of four calls between two CUDA events after one warm
call.  It reports the q12 route's count deltas to the q16 route (max and
slots that differ) and both routes' Matoms/s.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops import fused_kernel as fk
from . import _study

ATOM_TILE = 128
W = 32
M_PAD = 2_097_152
MAX_Q12_EXTENT = 100.0
N_POINTS = 100


def pack_q12(structures, probe):
    """Numpy spec of the 6B/slot packer (C++ port follows the winner)."""
    tiles_per = [-(-s[0].shape[0] // ATOM_TILE) for s in structures]
    total_tiles = sum(tiles_per)
    m = total_tiles * ATOM_TILE
    wire_a = np.zeros(m, dtype=np.uint32)
    wire_b = np.zeros(m, dtype=np.uint16)
    tparams = np.zeros((total_tiles, 4), dtype=np.float32)
    tparams[:, 3] = 1.0
    tmeta = np.zeros((total_tiles, 2), dtype=np.int32)

    # Palette: index 0 reserved for padding slots.
    palette_vals: dict[float, int] = {}
    palette = [np.float32(0.0)]

    offsets = []
    tile0 = 0
    pos = 0
    for coords, radii, _g in structures:
        n = coords.shape[0]
        nt = -(-n // ATOM_TILE)
        center = np.round(
            coords.mean(axis=0, dtype=np.float64) * 256.0
        ) / 256.0
        c = coords - center.astype(np.float32)
        order = np.argsort(fk._morton_codes(c), kind="stable")
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)
        c = c[order]
        r_eff = (radii[order] + np.float32(probe)).astype(np.float32)

        cmin = c.min(axis=0)
        extent = float((c.max(axis=0) - cmin).max())
        if extent > MAX_Q12_EXTENT:
            return None
        scale = np.float32(max(extent, 1e-6) / 4095.0)
        q = np.clip(
            np.rint((c - cmin[None, :]) / scale), 0, 4095
        ).astype(np.uint32)
        ridx = np.empty(n, dtype=np.uint32)
        for k, rv in enumerate(r_eff):
            key = float(rv)
            idx = palette_vals.get(key)
            if idx is None:
                if len(palette) >= 256:
                    return None
                idx = len(palette)
                palette_vals[key] = idx
                palette.append(np.float32(key))
            ridx[k] = idx
        sl = slice(pos, pos + n)
        wire_a[sl] = q[:, 0] | (q[:, 1] << 12) | ((q[:, 2] >> 4) << 24)
        wire_b[sl] = ((q[:, 2] & 0xF) | (ridx << 4)).astype(np.uint16)
        t0, t1 = tile0, tile0 + nt
        tparams[t0:t1, 0:3] = cmin
        tparams[t0:t1, 3] = scale
        tmeta[t0:t1, 0] = tile0
        tmeta[t0:t1, 1] = nt
        offsets.append((pos, n, inv))
        tile0 += nt
        pos += nt * ATOM_TILE
    pal = np.zeros(256, dtype=np.float32)
    pal[: len(palette)] = palette
    return wire_a, wire_b, pal, tparams, tmeta, offsets


def dequant_q12(wire_a, wire_b, palette, tparams):
    """q12 wire -> (planes [N_PLANES, M] f32, qvalid [M] bool): the
    words widened to int64 and masked (they travel as int32 / int16),
    the radius by a palette gather, the coordinates q*scale+origin."""
    wa = wire_a.to(torch.int64) & 0xFFFFFFFF
    wb = wire_b.to(torch.int64) & 0xFFFF
    q3 = torch.stack([
        wa & 0xFFF,
        (wa >> 12) & 0xFFF,
        (((wa >> 24) & 0xFF) << 4) | (wb & 0xF),
    ]).to(torch.float32)
    ridx = (wb >> 4) & 0xFF
    qvalid = ridx > 0
    return fk._planes(q3, palette[ridx], qvalid, tparams), qvalid


def fused_sasa_q12_banded(wire_a, wire_b, palette, tparams, tmeta, sphere,
                          *, n_points: int, w: int):
    """6 B/slot q12 wire + the banded cull -> per-slot occlusion counts."""
    planes, qvalid = dequant_q12(wire_a, wire_b, palette, tparams)
    jlist = fk.build_jlist_banded(planes, qvalid, tmeta, w=w)
    return fk._counts_out(fk.fused_counts(planes, jlist, sphere), n_points)


def pad_wires(q16, q12, slots: int):
    """Both packers' wires zero-padded to `slots` slots -> (q16 wire,
    q12 wire) without their offsets."""
    planes4, tparams16, tmeta16 = q16
    wire_a, wire_b, pal, tparams12, tmeta12 = q12
    m = planes4.shape[1]
    if m > slots:
        raise ValueError(f"{m} slots packed, more than {slots}")
    pad_t = (slots - m) // ATOM_TILE

    def tiles(a):
        return np.pad(a, ((0, pad_t), (0, 0)))

    return ((np.pad(planes4, ((0, 0), (0, slots - m))), tiles(tparams16),
             tiles(tmeta16)),
            (np.pad(wire_a, (0, slots - m)), np.pad(wire_b, (0, slots - m)),
             pal, tiles(tparams12), tiles(tmeta12)))


def r_eff_exact(wire, offsets, structures, probe, device) -> bool:
    """The q12 wire's r_eff, dequantized on `device`, equals radii + probe
    in f32 (the f32 path's r_eff) bit for bit at every real slot, and is
    0 at every other slot."""
    planes, _ = dequant_q12(*fk.to_device(wire[:4], device))
    got = planes[3].cpu().numpy()
    want = np.zeros_like(got)
    for (pos, n, inv), (_c, radii, _g) in zip(offsets, structures):
        want[pos:pos + n][inv] = radii + np.float32(probe)
    return bool(np.array_equal(got.view(np.uint32), want.view(np.uint32)))


def run(corpus_dir=None, device="cuda", *, slots: int = M_PAD, w: int = W,
        reps: int = 4) -> dict:
    """The study on one chunk; returns {"structures", "atoms", "slots",
    "pack12_s", "palette", "r_eff_exact", "max_dcount", "n_diff",
    "routes": {"q16"|"q12": {"first_ms", "ms", "matoms_s"}}} and where it
    ran (cpu_count, gpu_name, power_limit).  palette: the palette entries
    used, padding's included; r_eff_exact: see r_eff_exact()."""
    from ..ops import engine

    dev = engine.resolve_devices(device)[0]
    triples = _study.load_corpus(_study.bench_corpus(corpus_dir),
                                 slots=slots, max_tiles=w)
    atoms = sum(t[0].shape[0] for t in triples)
    *q16, _ = fk.pack_structures_q16(triples, _study.PROBE)
    t0 = time.perf_counter()
    q12 = pack_q12(triples, _study.PROBE)
    pack12_s = time.perf_counter() - t0
    if q12 is None:
        raise ValueError("a structure is over the q12 extent or palette")
    *q12, offsets12 = q12
    wire16, wire12 = pad_wires(q16, q12, slots)
    sphere = engine._sphere_device(N_POINTS, dev)

    def q16_route():
        return fk.fused_sasa_q16_banded(*fk.to_device(wire16, dev), sphere,
                                        n_points=N_POINTS, w=w).cpu()

    def q12_route():
        return fused_sasa_q12_banded(*fk.to_device(wire12, dev), sphere,
                                     n_points=N_POINTS, w=w).cpu()

    routes, counts = {}, {}
    for name, fn in (("q16", q16_route), ("q12", q12_route)):
        first_ms, ms, counts[name] = _study.timed(fn, dev, reps)
        routes[name] = {"first_ms": first_ms, "ms": ms,
                        "matoms_s": atoms / (ms * 1e-3) / 1e6}
    d = (counts["q12"].to(torch.int64) - counts["q16"].to(torch.int64)).abs()
    return {
        "structures": len(triples), "atoms": atoms, "slots": slots,
        "pack12_s": pack12_s, "palette": int(np.count_nonzero(q12[2])) + 1,
        "r_eff_exact": r_eff_exact(wire12, offsets12, triples, _study.PROBE,
                                   dev),
        "max_dcount": int(d.max()), "n_diff": int((d != 0).sum()),
        "routes": routes, **_study.where(dev),
    }


def lines(r: dict) -> list[str]:
    """The script's lines for a run() result, then where it ran."""
    q16, q12 = r["routes"]["q16"], r["routes"]["q12"]
    return [
        f"{r['structures']} structures, {r['atoms']} atoms; q12 numpy pack "
        f"{r['pack12_s']:.2f}s, palette {r['palette']} entries",
        f"q16  warm best {q16['ms']:7.1f}ms  {q16['matoms_s']:6.2f} Matoms/s "
        f"(incl. h2d)",
        f"  count deltas: max {r['max_dcount']}, n_diff {r['n_diff']}",
        f"q12  warm best {q12['ms']:7.1f}ms  {q12['matoms_s']:6.2f} Matoms/s "
        f"(incl. h2d)",
        f"q12 r_eff bit-equal to radii + probe: {r['r_eff_exact']}",
        _study.where_line(r),
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("corpus_dir", nargs="?", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    result = run(args.corpus_dir, args.device)
    for line in lines(result):
        print(line, flush=True)
    return 0 if result["r_eff_exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
