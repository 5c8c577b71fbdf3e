"""Production-pipeline stage accounting.

The round-2 postmortem (VERDICT.md, Weak #4) found the standalone profiler
disagreed with the headline bench by 4x because it measured a DIFFERENT
code path (single blocking compute, no overlapped waves, different padding).
The fix is to instrument the production pipeline itself: timers accumulate
here whenever RUSTSASA_TPU_PROFILE=1, and `bench.py`/`scripts/` dump them
after a run.  Overhead when disabled is one dict lookup per stage.

Stages are wall-clock intervals ON THE MAIN THREAD (the pipeline's serial
spine); `device_wait` is the only one that includes device time - it is the
block inside collect() waiting for readback, i.e. device time NOT hidden by
host work.  If the stages sum to ~the bench wall, the accounting is
trustworthy; the residual is printed so drift is visible.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

enabled = os.environ.get("RUSTSASA_TPU_PROFILE", "") == "1"

totals: dict[str, float] = defaultdict(float)
counts: dict[str, int] = defaultdict(int)


@contextmanager
def stage(name: str):
    if not enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        totals[name] += time.perf_counter() - t0
        counts[name] += 1


def add(name: str, seconds: float) -> None:
    if enabled:
        totals[name] += seconds
        counts[name] += 1


def reset() -> None:
    totals.clear()
    counts.clear()


def report(wall: float | None = None) -> str:
    lines = []
    tracked = 0.0
    for name in sorted(totals, key=lambda k: -totals[k]):
        lines.append(f"  {name:24s} {totals[name]:8.3f}s  x{counts[name]}")
        tracked += totals[name]
    if wall is not None:
        lines.append(f"  {'(untracked residual)':24s} {wall - tracked:8.3f}s")
        lines.append(f"  {'WALL':24s} {wall:8.3f}s")
    return "\n".join(lines)
