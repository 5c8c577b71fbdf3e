"""One rank of a distributed directory batch.

    python -m rustsasa_tpu_torch.parallel.worker <init_method> <world_size>
        <rank> <input_dir> <output_dir> <report.json> [--device cuda|cpu]

Joins the Gloo group at `init_method` (tcp://localhost:<port>), runs its
shard of `input_dir` at residue level with JSON output through
`process_directory_distributed` and writes the all-reduced
`GlobalReport` as JSON, with its rank, the world size, its elapsed
seconds (`elapsed_s`, to the end of the final all-reduce, so every rank
reads the slowest rank's time), its own seconds in its shard (`shard_s`,
before that all-reduce), its device and its kernel launches.  Every rank
must write the same global metrics.  "cuda" (the default) puts rank r on card r mod the visible
cards, so ranks share a card when there are more ranks than cards; it
raises without CUDA.

`run_workers` starts a whole group of them on this host and waits.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(world_size: int, input_dir: str, output_dir: str,
                report_dir: str, device: str = "cuda", timeout: float = 900,
                env: dict | None = None) -> tuple[list[dict], float]:
    """Start `world_size` workers on this host (one Gloo group on a free
    localhost port), wait for all of them and return (their reports in
    rank order, wall seconds from the first start to the last exit).
    Raises if any exits non-zero or outlives `timeout`; none is left
    running."""
    os.makedirs(report_dir, exist_ok=True)
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    reports = [os.path.join(report_dir, f"report_{world_size}_{rank}.json")
               for rank in range(world_size)]
    for path in reports:
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    deadline = t0 + timeout
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rustsasa_tpu_torch.parallel.worker", init,
         str(world_size), str(rank), input_dir, output_dir, reports[rank],
         "--device", device],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for rank in range(world_size)]
    try:
        errs = [p.communicate(
            timeout=max(1.0, deadline - time.perf_counter()))[1]
            for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            raise RuntimeError(f"worker {rank} of {world_size} exited "
                               f"{p.returncode}:\n{err[-3000:]}")
    out = []
    for path in reports:
        with open(path, encoding="utf-8") as f:
            out.append(json.load(f))
    return out, wall


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rustsasa_tpu_torch.parallel.worker")
    parser.add_argument("init_method")
    parser.add_argument("world_size", type=int)
    parser.add_argument("rank", type=int)
    parser.add_argument("input_dir")
    parser.add_argument("output_dir")
    parser.add_argument("report")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..api import SASAOptions
    from ..levels import Level
    from ..ops import _kernels
    from ..ops.engine import BatchedSasaEngine, SasaParams, _device
    from .distributed import (initialize_distributed,
                              process_directory_distributed)

    device = _device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
    initialize_distributed(args.init_method, args.world_size, args.rank)
    try:
        options = SASAOptions(level=Level.RESIDUE, device=str(device))
        engine = BatchedSasaEngine(
            SasaParams(probe_radius=options.probe_radius,
                       n_points=options.n_points), device=device)
        t0 = time.perf_counter()
        report = process_directory_distributed(
            args.input_dir, args.output_dir, options, "json",
            progress=False, engine=engine)
        elapsed = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(args.report, "w", encoding="utf-8") as f:
        json.dump({
            "n_files": report.n_files, "n_ok": report.n_ok,
            "n_errors": report.n_errors, "total_area": report.total_area,
            "rank": args.rank, "world_size": args.world_size,
            "elapsed_s": elapsed, "shard_s": report.shard_s,
            "device": str(device),
            "launches": dict(_kernels.launch_counts),
        }, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
