"""pack_s.md: the program's pack stage, seconds a thousand frames."""

from benchmark.readers import pack_s_per_kframe as read  # noqa: F401
