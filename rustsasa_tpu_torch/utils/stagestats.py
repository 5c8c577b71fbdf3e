"""Host stage spans and counters of the port's production paths.

Enabled by RUSTSASA_TPU_PROFILE=1, read once at import; `bench.py`, the
benchmark harness and `scripts/` read the results after a run.

`stage(name)` times one span of host work: `totals[name]` sums its
inclusive wall seconds over every call and thread, `counts[name]` the
calls.  Spans may come from any thread: the sums are taken under a lock.
Each span also opens a `torch.profiler.record_function` annotation
`stage.<name>`, so that under a profiler it lands on the profiler's clock
beside the device's kernel and copy events, and an idle gap of the
device can be traced to the host step that was running.  `tally(name, n)`
adds `n` to the counter `tallies[name]`, under the same lock.

On the trajectory path (`trajectory.compute_trajectory_sasa` and the
engine below it) the spans are leaves that do not overlap on the calling
thread: topology, dcd_read, gather, route, pack, h2d, launch,
device_wait, unpack, frame_sums.  Their totals add up to the pass less
its loop glue.  `device_wait` is the one that holds device time: the
host blocked on a chunk's readback, i.e. device time not hidden by host
work.

Disabled, a span is one branch: no lock, no torch call, nothing kept.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

enabled = os.environ.get("RUSTSASA_TPU_PROFILE", "") == "1"

totals: dict[str, float] = defaultdict(float)
counts: dict[str, int] = defaultdict(int)
tallies: dict[str, int] = defaultdict(int)
_lock = threading.Lock()


@contextmanager
def stage(name: str):
    if not enabled:
        yield
        return
    from torch.profiler import record_function

    with record_function(f"stage.{name}"):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with _lock:
                totals[name] += dt
                counts[name] += 1


def tally(name: str, n: int) -> None:
    """Add `n` to the counter `name`.  Callers guard the computation of
    `n` with `if stagestats.enabled:`."""
    if enabled:
        with _lock:
            tallies[name] += n


def reset() -> None:
    with _lock:
        totals.clear()
        counts.clear()
        tallies.clear()


def report(wall: float | None = None) -> str:
    with _lock:
        spans = dict(totals)
        calls = dict(counts)
        counters = dict(tallies)
    lines = []
    tracked = 0.0
    for name in sorted(spans, key=lambda k: -spans[k]):
        lines.append(f"  {name:24s} {spans[name]:8.3f}s  x{calls[name]}")
        tracked += spans[name]
    if wall is not None:
        lines.append(f"  {'(untracked residual)':24s} {wall - tracked:8.3f}s")
        lines.append(f"  {'WALL':24s} {wall:8.3f}s")
    for name in sorted(counters):
        lines.append(f"  {name:24s} {counters[name]:12d}")
    return "\n".join(lines)
