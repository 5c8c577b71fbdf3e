"""The quantities the metric files of `metrics/` read from a run.

Each reader takes the run's context (`run.Context`) and returns a number,
or None where the run has nothing to read: the harness then leaves the
metric out of the line.  A file `metrics/<name>.py` binds one of these,
or a reader of its own, to the name `read`.
"""

from __future__ import annotations

from . import work


def setup_seconds(ctx):
    return ctx.setup_s


def _rate(ctx, unit, scale=1.0):
    done = ctx.work.get(unit)
    if not done or ctx.window_s <= 0:
        return None
    return done / ctx.window_s / scale


def frames_per_s(ctx):
    """Frames of the whole trajectories the window completed, a second."""
    return _rate(ctx, "frames")


def file_matoms_per_s(ctx):
    """Atoms of the files of the whole passes the window completed (every
    atom record of the first model, as the corpus rule counts them),
    millions a second."""
    return _rate(ctx, "file_atoms", 1e6)


def batch_matoms_per_s(ctx):
    """Atoms handed to the engine in the whole passes the window
    completed, millions a second."""
    return _rate(ctx, "atoms", 1e6)


def idle_share(ctx):
    """Per cent of the traced window in which no kernel, copy or memset
    ran on the device."""
    t = ctx.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernels_roofline(ctx):
    """Per cent: the least time the window's SASA needs on the card
    (`work.py`, from the inputs' geometry) over the time of every kernel
    the program ran in the traced window."""
    t = ctx.trace
    geometry = ctx.geometry()
    if not t or t["kernel_s"] <= 0 or geometry is None:
        return None
    return 100.0 * work.least_seconds(*geometry) / t["kernel_s"]


def _stage(ctx, name, per):
    if not ctx.stages or name not in ctx.stages:
        return None
    n = ctx.work.get(per) if per != "passes" else ctx.passes
    if not n:
        return None
    return ctx.stages[name] / n


def pack_s_per_kframe(ctx):
    """The program's `pack` stage seconds over 1,000 frames."""
    v = _stage(ctx, "pack", "frames")
    return None if v is None else 1000.0 * v


def pack_s_per_pass(ctx):
    return _stage(ctx, "pack", "passes")


def load_wait_s_per_pass(ctx):
    return _stage(ctx, "load_wait", "passes")


def emit_wait_s_per_pass(ctx):
    return _stage(ctx, "emit_wait", "passes")
