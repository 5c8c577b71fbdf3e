"""pack_s.lib: the program's pack stage, seconds a pass."""

from benchmark.readers import pack_s_per_pass as read  # noqa: F401
