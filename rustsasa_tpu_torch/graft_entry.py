"""Entry points of one forward step and of the multi-device step.

Port of `__graft_entry__.py`.

entry(device): one list-path SASA step (`neighbors._sasa_batched`: the
neighbor phase, then the occlusion; on CUDA the neighbor and list
occlusion kernels) over an example batch, returned as (fn, args) with
the args on the device.

dryrun_multichip(devices): one full sharded step over a device list
(`parallel.mesh`), then the fused engine's chunk dealt round-robin to
the same entries, held to the reference's parity bound.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _example_batch(b=4, n=256, n_points=100, seed=0):
    """The reference's example batch: the same numpy RNG calls, so the
    arrays are identical."""
    from .ops.engine import _sphere_packed

    rng = np.random.default_rng(seed)
    packed = np.zeros((b, n, 4), dtype=np.float32)
    packed[:, :, 0:3] = rng.uniform(0.0, 30.0, size=(b, n, 3))
    packed[:, :, 3] = rng.uniform(1.4, 1.9, size=(b, n))
    gid = np.tile(np.arange(n, dtype=np.int32), (b, 1))
    sphere_packed = _sphere_packed(n_points)
    return packed, gid, sphere_packed


def entry(device="cuda"):
    """(fn, args) for one list-path step at k = 64, 100 points, probe
    1.4; fn(*args) -> (sasa [B, N], max_count)."""
    from .ops import neighbors
    from .ops.engine import _device

    dev = _device(device)
    fn = functools.partial(neighbors._sasa_batched, k=64, n_points=100,
                           probe=1.4)
    args = tuple(torch.from_numpy(a).to(dev) for a in _example_batch())
    return fn, args


def dryrun_multichip(devices) -> None:
    """Run one sharded list step over `devices` and the fused engine's
    round-robin over the same entries, and check them against each other.

    The fused wires ship u16-quantized coordinates; an occlusion margin
    within ~1e-3 A of zero may flip one test point against the f32 list
    step, worth 4 pi r_eff^2 / 100 <= ~1.4 A^2.  As in the reference: at
    most 3.0 A^2 an atom, and at most 5 % of atoms over 1e-2.
    """
    from .ops.engine import DeviceRing, RouteCounts, _compute_fused
    from .parallel.mesh import make_sharded_sasa, put_batch_sharded

    ring = DeviceRing(devices)
    n_dev = len(ring)
    b = max(n_dev * 2, 4)
    packed, gid, sphere_packed = _example_batch(b=b, n=128, n_points=100)
    step = make_sharded_sasa(ring.devices, k=64, n_points=100)
    sasa, total, max_count = step(put_batch_sharded(ring.devices, packed),
                                  put_batch_sharded(ring.devices, gid),
                                  sphere_packed)
    sasa_np = sasa.cpu().numpy()
    if sasa_np.shape != (b, 128) or not float(total[0]) > 0.0:
        raise AssertionError(f"sharded step: shape {sasa_np.shape}, total "
                             f"{float(total[0])}")

    n_sub = min(b, 4)
    structures = [(packed[i, :, 0:3], packed[i, :, 3], gid[i])
                  for i in range(n_sub)]
    # The reference sends one chunk of these structures to its first
    # device.  Here the same chunk goes once to every entry, in turn
    # through the ring (one chunk a structure would quantize each on its
    # own grid and move more points than the bound allows); every entry's
    # result must be the same bytes.
    routes = RouteCounts(n_dev)
    pending = [_compute_fused(structures, probe=1.4, n_points=100,
                              ring=ring, routes=routes)
               for _ in range(n_dev)]
    results = [p.collect() for p in pending]
    outs = results[0]
    entries = routes.entries
    if len(outs) != n_sub or any(o.shape != (128,) for o in outs):
        raise AssertionError("fused round-robin: wrong output shapes")
    if entries != [1] * n_dev or any(
            not np.array_equal(a, b)
            for other in results[1:] for a, b in zip(outs, other)):
        raise AssertionError(f"fused chunks per entry {entries}, or "
                             "entries disagree")
    for i, out in enumerate(outs):
        diff = np.abs(out - sasa_np[i])
        if not diff.max() <= 3.0:
            raise AssertionError(f"structure {i}: max diff {diff.max()}")
        if not (diff > 1e-2).mean() <= 0.05:
            raise AssertionError(f"structure {i}: "
                                 f"{100 * (diff > 1e-2).mean():.1f}% of "
                                 "atoms differ")
    print(f"dryrun_multichip OK: {n_dev} device entries "
          f"({', '.join(map(str, ring.devices))}), batch={b}, "
          f"total_area={float(total[0]):.1f} (sharded list step), fused "
          f"chunks per entry {entries} on {n_sub} structures, "
          f"max_neighbors={int(max_count[0])}")
