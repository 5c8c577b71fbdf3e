"""Multi-process directory batch on `torch.distributed`.

Port of `rustsasa_tpu/parallel/distributed.py`.  Each process (rank)
reads its own round-robin shard of the sorted file listing, runs the
whole batch pipeline on its own engine and writes its own outputs; the
only collective is the run metrics (file, success and error counts and
the total area), one all-reduce of five host numbers.  The group runs on
Gloo: it reduces host tensors, which is right for five numbers, and it
admits several ranks on one card, which NCCL refuses.

A one-process run needs no group: the shard is everything and the
reductions are the identity.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field, replace

import numpy as np
import torch
import torch.distributed as dist

# Long enough for the slowest rank's shard: ranks meet only at the
# pre-warm all-reduce and at the final one.
TIMEOUT = datetime.timedelta(seconds=1800)


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None) -> bool:
    """Join the Gloo process group when a multi-process run is configured.

    Returns True when running multi-process.  Arguments default to
    torchrun's variables: `MASTER_ADDR` and `MASTER_PORT` (as
    tcp://addr:port), `WORLD_SIZE` and `RANK`.  A run of one process is a
    no-op.  The backend is Gloo and nothing else: `allreduce_metrics`
    reduces host tensors, which NCCL rejects, and NCCL refuses two ranks
    on one card.
    """
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        init_method = f"tcp://{addr}:{port}" if addr and port else None
    if world_size is None:
        env = os.environ.get("WORLD_SIZE")
        world_size = int(env) if env else None
    if rank is None:
        env = os.environ.get("RANK")
        rank = int(env) if env else None
    if not init_method or not world_size or world_size <= 1:
        return False
    if rank is None:
        raise ValueError("a multi-process run needs its rank (RANK)")
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)
    return True


def _rank_and_size() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_files(files: list[str], process_index: int | None = None,
                process_count: int | None = None) -> list[str]:
    """Round-robin file shard of this rank (deterministic, size-balanced
    when the listing is sorted)."""
    rank, size = _rank_and_size()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    return files[pi::pc]


@dataclass
class GlobalReport:
    """The all-reduced run metrics, the same on every rank, and this
    rank's own seconds in its shard (`shard_s`, not reduced: the time
    before the final all-reduce, which waits for the slowest rank)."""

    n_files: int
    n_ok: int
    n_errors: int
    total_area: float
    shard_s: float = field(default=0.0, compare=False)


def allreduce_metrics(n_files: int, n_ok: int, n_errors: int,
                      total_area: float) -> GlobalReport:
    """Sum run metrics over all ranks (the identity on one process).

    The reference's arithmetic: the counts ride as int32, total_area as
    a two-float Dekker split (hi = f32(x), lo = f32(x - hi)) summed
    componentwise and recombined in float64, so a one-process report is
    the reference's bit for bit.
    """
    hi = np.float32(total_area)
    lo = np.float32(total_area - float(hi))
    counts = np.array([n_files, n_ok, n_errors], dtype=np.int32)
    area2 = np.array([hi, lo], dtype=np.float32)
    if _rank_and_size()[1] == 1:
        counts_sum, area_sum = counts, area2.astype(np.float64)
    else:
        c = torch.from_numpy(counts)
        a = torch.from_numpy(area2)
        dist.all_reduce(c, op=dist.ReduceOp.SUM)
        dist.all_reduce(a, op=dist.ReduceOp.SUM)
        counts_sum = c.numpy()
        area_sum = a.numpy().astype(np.float64)
    return GlobalReport(
        n_files=int(counts_sum[0]),
        n_ok=int(counts_sum[1]),
        n_errors=int(counts_sum[2]),
        total_area=float(area_sum[0] + area_sum[1]),
    )


def process_directory_distributed(input_dir: str, output_dir: str, options,
                                  output_format: str, **kwargs
                                  ) -> GlobalReport:
    """Sharded directory batch: this rank's files through
    `process_directory` (kwargs, such as `engine=`, go to it), then the
    metrics all-reduced.  Every rank must call it."""
    from ..batch import process_directory

    if _rank_and_size()[1] > 1:
        # Meet once while the ranks are still in step after start-up: the
        # first collective waits for every peer, and one issued only at
        # the end would wait out the slowest rank's whole shard.
        allreduce_metrics(0, 0, 0, 0.0)

    entries = sorted(os.listdir(input_dir))
    files = [f for f in entries if os.path.isfile(os.path.join(input_dir, f))]
    report = process_directory(
        input_dir, output_dir, options, output_format,
        file_filter=set(shard_files(files)), **kwargs,
    )
    reduced = allreduce_metrics(report.n_files, report.n_ok,
                                len(report.errors), report.total_area)
    return replace(reduced, shard_s=report.elapsed_s)
