"""topology_s.md: the program's topology span, seconds a thousand frames."""

from benchmark.spans import span_s_per_kframe


def read(ctx):
    return span_s_per_kframe(ctx, "topology")
