"""Data parallelism over a list of devices for the list-path SASA step.

Port of `rustsasa_tpu/parallel/mesh.py`.  The reference's mesh is a 1-D
`jax.sharding.Mesh` over local devices with the structure batch sharded
on its axis, and `shard_map` runs one XLA scan per shard with `psum` /
`pmax` for the metrics.  Here the mesh is a list of `torch.device`s; each
shard runs `neighbors._sasa_batched` (on CUDA the neighbor and list
occlusion kernels, one launch each) on its entry's own stream, and the
metrics are reduced on the first entry.  Per-structure results need no collective: each structure's
neighbor phase is its own and `tile_kmax` only bounds loops, so the
sharded step is byte-equal to `_sasa_batched` over the whole batch.
"""

from __future__ import annotations

import torch

from ..ops import neighbors
from ..ops.engine import DeviceRing, _device, resolve_devices


def make_mesh(n_devices: int | None = None,
              device_type: str = "cuda") -> list[torch.device]:
    """The first `n_devices` visible devices of `device_type` (all of
    them by default); raises if fewer exist.  The CPU is one device."""
    visible = resolve_devices(device_type)
    if n_devices is None:
        return visible
    if not 0 < n_devices <= len(visible):
        raise ValueError(f"{n_devices} {device_type} devices asked for, "
                         f"{len(visible)} visible")
    return visible[:n_devices]


def put_batch_sharded(devices, array) -> list[torch.Tensor]:
    """Split a host array (or tensor) on axis 0 into len(devices) equal
    shards, shard i on devices[i].  The leading axis must divide."""
    devices = [_device(d) for d in devices]
    t = torch.as_tensor(array)
    if t.shape[0] % len(devices):
        raise ValueError(f"batch {t.shape[0]} does not divide over "
                         f"{len(devices)} devices")
    return [part.to(dev).contiguous()
            for part, dev in zip(t.chunk(len(devices)), devices)]


def make_sharded_sasa(devices, *, k: int, n_points: int, probe: float = 1.4):
    """Build the sharded batched SASA step over `devices`.

    Returns fn(packed [B, N, 4], group_id [B, N], sphere [P, 4]) ->
    (sasa [B, N] f32, total [1] f64, max_count [1] i64), all on the first
    entry.  packed and group_id are host arrays or `put_batch_sharded`
    shards; B must divide by len(devices).  total is the sum of the
    shards' sums and max_count their max (the reference's psum / pmax).
    total is summed in float64: exact, and so independent of the
    sharding, while it stays under 2^53 times the smallest ulp of the
    per-atom values (2^27 A^2 at 100 points, where no nonzero value is
    under 2^-3).
    """
    ring = DeviceRing(devices)
    first = ring.devices[0]

    def step(packed, group_id, sphere):
        if not isinstance(packed, (list, tuple)):
            packed = put_batch_sharded(ring.devices, packed)
        if not isinstance(group_id, (list, tuple)):
            group_id = put_batch_sharded(ring.devices, group_id)
        if not len(packed) == len(group_id) == len(ring):
            raise ValueError(f"{len(packed)} / {len(group_id)} shards for "
                             f"{len(ring)} devices")
        sphere = torch.as_tensor(sphere)
        shards = []
        for entry, dev in enumerate(ring.devices):
            p, g = packed[entry], group_id[entry]
            s = sphere.to(dev)
            stream = ring.streams[entry]
            if stream is not None:
                # The shard's inputs were made on the caller's stream.
                stream.wait_stream(torch.cuda.current_stream(dev))
                for t in (p, g, s):
                    t.record_stream(stream)
            with ring.stream(entry):
                sasa, mc = neighbors._sasa_batched(
                    p, g, s, k=k, n_points=n_points, probe=probe)
                shards.append((sasa, sasa.double().sum(), mc))
        for entry, outs in enumerate(shards):
            stream = ring.streams[entry]
            if stream is not None:
                # The gather below runs on the caller's streams.
                caller = torch.cuda.current_stream(stream.device)
                caller.wait_stream(stream)
                for t in outs:
                    t.record_stream(caller)
        sasa = torch.cat([out[0].to(first) for out in shards])
        total = torch.stack([out[1].to(first) for out in shards]).sum()
        max_count = torch.stack([out[2].to(first) for out in shards]).max()
        return sasa, total.reshape(1), max_count.reshape(1)

    return step
