"""slot_fill.md: per cent of the dispatched atom slots that hold a real atom."""

from benchmark.spans import slot_fill as read  # noqa: F401
