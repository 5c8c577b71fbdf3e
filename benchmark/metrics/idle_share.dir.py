"""idle_share.dir: per cent of the traced window the device ran nothing."""

from benchmark.readers import idle_share as read  # noqa: F401
