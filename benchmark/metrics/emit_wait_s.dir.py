"""emit_wait_s.dir: the program's emit_wait stage, seconds a pass."""

from benchmark.readers import emit_wait_s_per_pass as read  # noqa: F401
