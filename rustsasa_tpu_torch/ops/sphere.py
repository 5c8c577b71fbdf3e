"""Golden-section spiral sphere sampling.

Quasi-uniform unit-sphere test points for the Shrake-Rupley algorithm
(reference: src/lib.rs:43-66).  Computed in float32 with the same truncated
golden-ratio constant so point coordinates match the reference in f32.
"""

from __future__ import annotations

import functools

import numpy as np

from ..constants import ANGLE_INCREMENT


@functools.lru_cache(maxsize=32)
def sphere_points(n_points: int) -> np.ndarray:
    """Return [n_points, 3] float32 unit vectors on the golden spiral.

    t = i/n, inclination = acos(1 - 2t), azimuth = 2*pi*phi*i.
    """
    i = np.arange(n_points, dtype=np.float32)
    t = i * np.float32(1.0 / n_points)
    inclination = np.arccos(np.float32(1.0) - np.float32(2.0) * t)
    azimuth = np.float32(ANGLE_INCREMENT) * i
    sin_inc = np.sin(inclination)
    pts = np.stack(
        [sin_inc * np.cos(azimuth), sin_inc * np.sin(azimuth), np.cos(inclination)],
        axis=1,
    )
    return np.ascontiguousarray(pts, dtype=np.float32)


def padded_sphere_points(n_points: int, pad_to: int) -> tuple[np.ndarray, np.ndarray]:
    """Sphere points padded along the point axis to a lane-friendly size.

    Returns (points [pad_to, 3], valid mask [pad_to]).  Padding points are
    zero vectors with a False mask; the kernel ignores them.
    """
    pts = sphere_points(n_points)
    if pad_to < n_points:
        raise ValueError(f"pad_to={pad_to} < n_points={n_points}")
    padded = np.zeros((pad_to, 3), dtype=np.float32)
    padded[:n_points] = pts
    mask = np.zeros(pad_to, dtype=bool)
    mask[:n_points] = True
    return padded, mask
