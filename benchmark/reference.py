"""Plain Shrake-Rupley in PyTorch: the yardstick `correct` is judged by.

An atom i of radius r_i gets the sphere of radius R_i = r_i + probe,
sampled at the golden-spiral points (`sphere.py`); a point is buried
when it lies strictly inside the probe-grown sphere of another atom j,
|x_i + R_i s_k - x_j| < R_j, and atom i's SASA is its free points over
all of them times 4 pi R_i^2.  No neighbor list survives from one call
to the next, no quantization, no packing: candidates are found afresh
from all pairwise distances (with a slack, so the set is a superset of
the pairs in reach), then every point is tested against every
candidate in `dtype`.  float64 is the reference; a lower `dtype` (the
control) runs the very same arithmetic in that precision.  Imports
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .sphere import sphere_points

# Elements of the [block, points, candidates] tensors a step may hold.
_STEP_ELEMENTS = 1 << 24
# Candidate slack (A) over R_i + R_j: the test itself decides burial.
_SLACK = 0.25


def free_points(coords, radii, probe: float, n_points: int, *,
                dtype=torch.float64, device="cpu") -> np.ndarray:
    """[N] int64 free sphere points of each atom; every atom excludes only
    itself (the program is handed per-atom group ids)."""
    dev = torch.device(device)
    x64 = torch.as_tensor(np.asarray(coords, np.float64), device=dev)
    r64 = torch.as_tensor(np.asarray(radii, np.float64), device=dev) + probe
    n = x64.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    x = torch.as_tensor(np.asarray(coords, np.float32), device=dev).to(dtype)
    r = (torch.as_tensor(np.asarray(radii, np.float32), device=dev)
         + probe).to(dtype)
    s = torch.as_tensor(sphere_points(n_points), device=dev).to(dtype)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    rows = max(1, min(n, _STEP_ELEMENTS // max(n, 1)))
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        d2 = torch.cdist(x64[lo:hi], x64).square_()
        reach = (r64[lo:hi, None] + r64[None, :] + _SLACK).square_()
        cand = d2 < reach
        cand[torch.arange(hi - lo, device=dev),
             torch.arange(lo, hi, device=dev)] = False
        counts = cand.sum(dim=1)
        k = max(int(counts.max()), 1)
        nbr = torch.argsort(cand.to(torch.int8), dim=1, descending=True,
                            stable=True)[:, :k]
        valid = torch.arange(k, device=dev)[None, :] < counts[:, None]
        step = max(1, _STEP_ELEMENTS // (n_points * k))
        for a in range(0, hi - lo, step):
            b = min(hi - lo, a + step)
            i = torch.arange(lo + a, lo + b, device=dev)
            pts = x[i, None, :] + r[i, None, None] * s[None, :, :]
            j = nbr[a:b]
            xj = x[j]  # [B, K, 3]
            d = ((pts[:, :, None, 0] - xj[:, None, :, 0]).square()
                 + (pts[:, :, None, 1] - xj[:, None, :, 1]).square()
                 + (pts[:, :, None, 2] - xj[:, None, :, 2]).square())
            rj2 = r[j].square()
            buried = ((d < rj2[:, None, :]) & valid[a:b, None, :]).any(dim=2)
            out[lo + a:lo + b] = n_points - buried.sum(dim=1)
    return out.cpu().numpy()


def point_area(radii, probe: float, n_points: int) -> np.ndarray:
    """[N] float64 area one sphere point stands for: 4 pi R^2 / P."""
    big_r = np.asarray(radii, np.float64) + probe
    return 4.0 * math.pi * big_r * big_r / n_points


def atom_sasa(coords, radii, probe: float, n_points: int, *,
              dtype=torch.float64, device="cpu") -> np.ndarray:
    """[N] float64 SASA of each atom (A^2)."""
    free = free_points(coords, radii, probe, n_points, dtype=dtype,
                       device=device)
    return free * point_area(radii, probe, n_points)


def residue_sums(values, residue, n_residues: int) -> np.ndarray:
    """[R] float64 sums of per-atom `values` by residue index."""
    return np.bincount(residue, weights=np.asarray(values, np.float64),
                       minlength=n_residues)
