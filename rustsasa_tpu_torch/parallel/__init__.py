"""Scale-out for the port: device lists and multi-process corpus sharding.

Port of `rustsasa_tpu/parallel/`.  The reference shards a structure
batch over a `jax.sharding.Mesh` and reduces its run metrics with
`psum`; here a mesh is a list of `torch.device`s, each shard runs on its
entry's own CUDA stream (`mesh.py`), and processes share their metrics
through `torch.distributed` (`distributed.py`, started by `worker.py` or
`torchrun`).  One card may be named several times: two streams, or two
ranks, on one H100.
"""
