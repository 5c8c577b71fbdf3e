"""The benchmark's input generators, driven by the seed.

Frozen copies of the program's own (sound) generators, so that a change
to the program cannot change what it is measured on:

* `corpus_plan`: `rustsasa_tpu_torch.bench.build_corpus`'s rule (the
  largest ascending-size prefix of the structures whose mean atom count
  stays at or under the proteome's, cycled until both the file and the
  atom targets are met), with the copies' order drawn from the seed.
* `jitter_frames`: `rustsasa_tpu_torch.benches.md_trajectory`'s frames
  (the topology's coordinates plus N(0, sigma) per frame and axis).
* `write_dcd`: a little-endian CHARMM DCD without unit cell.
* `poses`: rigid motions (uniform rotation, translation in a cube).
"""

from __future__ import annotations

import os

import numpy as np


def corpus_plan(sizes: dict, target_files: int, target_atoms: int,
                seed: int) -> list:
    """Structure names, one a copy, in a seeded order: every seed gets
    the same multiset of copies."""
    target_mean = target_atoms / target_files
    prefix, total = [], 0
    for name in sorted(sizes, key=lambda n: (sizes[n], n)):
        if prefix and (total + sizes[name]) / (len(prefix) + 1) > target_mean:
            break
        prefix.append(name)
        total += sizes[name]
    copies, atoms = [], 0
    while len(copies) < target_files or atoms < target_atoms:
        name = prefix[len(copies) % len(prefix)]
        copies.append(name)
        atoms += sizes[name]
    order = np.random.default_rng(seed).permutation(len(copies))
    return [copies[k] for k in order]


def jitter_frames(base: np.ndarray, n_frames: int, sigma: float,
                  seed: int) -> np.ndarray:
    """[n_frames, N, 3] float32: base plus N(0, sigma) noise."""
    rng = np.random.default_rng(seed)
    base = np.asarray(base, np.float32)
    return base[None, :, :] + rng.normal(
        0.0, sigma, size=(n_frames, base.shape[0], 3)).astype(np.float32)


def write_dcd(path: str, frames: np.ndarray) -> int:
    """Write [F, N, 3] frames as a DCD; returns the bytes written."""
    f_count, n_atoms, _ = frames.shape

    def rec(payload: bytes) -> bytes:
        n = np.int32(len(payload)).tobytes()
        return n + payload + n

    icntrl = np.zeros(20, dtype="<i4")
    icntrl[0] = f_count
    icntrl[1] = 1
    icntrl[2] = 1
    icntrl[19] = 24  # CHARMM version stamp
    head = (rec(b"CORD" + icntrl.tobytes())
            + rec(np.int32(1).tobytes() + b"benchmark trajectory".ljust(80))
            + rec(np.int32(n_atoms).tobytes()))
    body = np.empty((f_count, 3, n_atoms + 2), dtype="<f4")
    body[:, :, 1:-1] = np.transpose(frames, (0, 2, 1))
    marks = body.view("<i4")
    marks[:, :, 0] = 4 * n_atoms
    marks[:, :, -1] = 4 * n_atoms
    with open(path, "wb") as f:
        f.write(head)
        f.write(body.tobytes())
        # On disk before the window, not written back during it.
        f.flush()
        os.fsync(f.fileno())
    return len(head) + body.nbytes


def poses(n: int, max_shift: float, seed: int):
    """n rigid motions from the seed: ([n, 3, 3] float64 rotations,
    uniform over SO(3), [n, 3] float64 shifts uniform in a cube of half
    side max_shift)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], axis=1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], axis=1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], axis=1),
    ], axis=1)
    return rot, rng.uniform(-max_shift, max_shift, size=(n, 3))
