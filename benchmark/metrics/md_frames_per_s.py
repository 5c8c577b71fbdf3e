"""md_frames_per_s: trajectory frames completed a second over the window."""

from benchmark.readers import frames_per_s as read  # noqa: F401
