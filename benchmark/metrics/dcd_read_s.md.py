"""dcd_read_s.md: the program's dcd_read span, seconds a thousand frames."""

from benchmark.spans import span_s_per_kframe


def read(ctx):
    return span_s_per_kframe(ctx, "dcd_read")
