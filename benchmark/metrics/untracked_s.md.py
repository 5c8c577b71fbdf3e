"""untracked_s.md: window seconds outside the ten trajectory spans, a thousand frames."""

from benchmark.spans import untracked_s_per_kframe as read  # noqa: F401
