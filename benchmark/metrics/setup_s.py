"""setup_s: seconds from the harness's start to the window's (import, kernel load, inputs, warm-up)."""

from benchmark.readers import setup_seconds as read  # noqa: F401
