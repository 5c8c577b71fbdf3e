"""device_wait_s.md: the program's device_wait span, seconds a thousand frames."""

from benchmark.spans import span_s_per_kframe


def read(ctx):
    return span_s_per_kframe(ctx, "device_wait")
