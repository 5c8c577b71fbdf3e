"""batch_matoms_per_s: atoms through enqueue/collect a second, in millions."""

from benchmark.readers import batch_matoms_per_s as read  # noqa: F401
