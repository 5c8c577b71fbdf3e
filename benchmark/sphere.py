"""Golden-section spiral sphere points, frozen for the plain reference.

RustSASA's generator (src/lib.rs:43-66 there): point i of n at
inclination acos(1 - 2 i / n) and azimuth 2 pi phi i, with phi the
truncated f32 literal 1.618034, computed in float32.  The benchmark's
tests pin its output to fixed values, so the reference's points cannot
move with the program's.
"""

from __future__ import annotations

import math

import numpy as np

GOLDEN_RATIO = 1.618034
ANGLE_INCREMENT = 2.0 * math.pi * GOLDEN_RATIO


def sphere_points(n_points: int) -> np.ndarray:
    """[n_points, 3] float32 unit vectors on the golden spiral."""
    i = np.arange(n_points, dtype=np.float32)
    t = i * np.float32(1.0 / n_points)
    inclination = np.arccos(np.float32(1.0) - np.float32(2.0) * t)
    azimuth = np.float32(ANGLE_INCREMENT) * i
    sin_inc = np.sin(inclination)
    pts = np.stack([sin_inc * np.cos(azimuth), sin_inc * np.sin(azimuth),
                    np.cos(inclination)], axis=1)
    return np.ascontiguousarray(pts, dtype=np.float32)
