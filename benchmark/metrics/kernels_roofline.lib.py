"""kernels_roofline.lib: least SASA time over the kernels' time, per cent."""

from benchmark.readers import kernels_roofline as read  # noqa: F401
