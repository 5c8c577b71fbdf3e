"""The SASA work an input needs, counted from its geometry, and the peaks
of the card it is measured against.

The count depends on the atoms alone, never on how the program lists,
culls or tiles them: for every atom i and every other atom j with
|x_i - x_j| < R_i + R_j (R = radius + probe, the pairs whose spheres
can bury each other's points), each of the P sphere points of i needs
one test against j.  The least such test is 4 FP32 instructions: the
point's dot product with the pair's offset (FMUL, FFMA, FFMA) and one
compare against the pair's margin, folded into the point's predicate
(FSETP with its OR), since |R_i s_k|^2 is the same R_i^2 for every
point.  Bytes: each input byte read once (x, y, z, r as float32) and
each output byte written once (a float32 area), and the sphere.
"""

from __future__ import annotations

import numpy as np
import torch

INSTR_PER_POINT_TEST = 4
INPUT_BYTES_PER_ATOM = 16
OUTPUT_BYTES_PER_ATOM = 4
# NVIDIA H100 SXM (data sheet, dense, at the full 700 W): FP32 67
# TFLOP/s outside the tensor cores, i.e. 33.5T FP32 instructions/s
# counting an FMA as one, and 3.35 TB/s of HBM3.
PEAK_FP32_INSTR_PER_S = 33.5e12
PEAK_BYTES_PER_S = 3.35e12

_ROWS = 1 << 24


def pairs_in_reach(coords, radii, probe: float, *, device="cpu") -> int:
    """Ordered pairs (i, j), i != j, with |x_i - x_j| < R_i + R_j."""
    dev = torch.device(device)
    x = torch.as_tensor(np.asarray(coords, np.float32), device=dev)
    r = torch.as_tensor(np.asarray(radii, np.float32), device=dev) + probe
    n = x.shape[0]
    total = 0
    rows = max(1, _ROWS // max(n, 1))
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        d2 = torch.cdist(x[lo:hi], x).square_()
        reach = (r[lo:hi, None] + r[None, :]).square_()
        total += int((d2 < reach).sum()) - (hi - lo)  # drop i == j
    return total


def frame_pairs_in_reach(frames, radii, probe: float, *, device="cpu",
                         batch: int = 16) -> np.ndarray:
    """[F] pairs in reach of each frame of [F, N, 3] coordinates."""
    dev = torch.device(device)
    r = torch.as_tensor(np.asarray(radii, np.float32), device=dev) + probe
    reach = (r[:, None] + r[None, :]).square_()
    n = r.shape[0]
    out = np.empty(len(frames), dtype=np.int64)
    for lo in range(0, len(frames), batch):
        x = torch.as_tensor(np.asarray(frames[lo:lo + batch], np.float32),
                            device=dev)
        d2 = torch.cdist(x, x).square_()
        out[lo:lo + len(x)] = ((d2 < reach).sum(dim=(1, 2)) - n).cpu().numpy()
    return out


def sasa_work(pairs: int, atoms: int, n_points: int) -> tuple[float, float]:
    """(FP32 instructions, bytes) the SASA of `atoms` atoms with `pairs`
    pairs in reach needs at P = n_points."""
    instr = float(pairs) * n_points * INSTR_PER_POINT_TEST
    nbytes = float(atoms) * (INPUT_BYTES_PER_ATOM + OUTPUT_BYTES_PER_ATOM) \
        + 12.0 * n_points
    return instr, nbytes


def least_seconds(instr: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(instr / PEAK_FP32_INSTR_PER_S, nbytes / PEAK_BYTES_PER_S)
