"""Readers of the program's own spans and counters on the trajectory path.

The program (`rustsasa_tpu_torch.utils.stagestats`, enabled by the
harness in a `--trace 1` run) times each step of a trajectory pass under
one of ten spans that do not overlap on the calling thread, and counts
real atoms against dispatched slots at the engine's dispatch boundary.
Each reader takes the run's context (`run.Context`) and returns a number,
or None where the run has nothing to read: a run without tracing, no
frames, or a program that has no such span or counter.
"""

from __future__ import annotations

import sys

TRAJECTORY_SPANS = ("topology", "dcd_read", "gather", "route", "pack",
                    "h2d", "launch", "device_wait", "unpack", "frame_sums")
STAGESTATS = "rustsasa_tpu_torch.utils.stagestats"


def _kframes(ctx):
    frames = ctx.work.get("frames")
    return frames / 1000.0 if frames else None


def span_s_per_kframe(ctx, name):
    """The program's `name` span, seconds over 1,000 frames."""
    k = _kframes(ctx)
    if not ctx.stages or name not in ctx.stages or not k:
        return None
    return ctx.stages[name] / k


def untracked_s_per_kframe(ctx):
    """The window's seconds that none of the ten trajectory spans
    covers, over 1,000 frames: the part of the pass no span explains."""
    k = _kframes(ctx)
    if not ctx.stages or not k or any(
            s not in ctx.stages for s in TRAJECTORY_SPANS):
        return None
    return (ctx.window_s - sum(ctx.stages[s] for s in TRAJECTORY_SPANS)) / k


def slot_fill(ctx):
    """Per cent of the dispatched atom slots that hold a real atom, from
    the program's `atoms` and `slots` counters over the traced window
    (the harness resets them with the spans when the window opens)."""
    if not ctx.stages:
        return None
    tallies = getattr(sys.modules.get(STAGESTATS), "tallies", None)
    if not tallies or not tallies.get("atoms") or not tallies.get("slots"):
        return None
    return 100.0 * tallies["atoms"] / tallies["slots"]
