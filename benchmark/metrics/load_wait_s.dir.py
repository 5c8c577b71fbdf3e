"""load_wait_s.dir: the program's load_wait stage, seconds a pass."""

from benchmark.readers import load_wait_s_per_pass as read  # noqa: F401
