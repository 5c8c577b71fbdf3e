"""The readers of the program's trajectory spans and counters
(`spans.py`, the `*_s.md`, `untracked_s.md` and `slot_fill.md` metric
files) on a synthetic context."""

from __future__ import annotations

import sys
import types

import pytest

from benchmark import run, spans

SPAN_METRICS = [f"{s}_s.md" for s in spans.TRAJECTORY_SPANS if s != "pack"]


def _ctx(stages, frames=2500, window_s=10.0):
    return run.Context(setup_s=1.0, window_s=window_s, passes=4,
                       work={"frames": frames} if frames else {},
                       stages=stages, trace=None, geometry=None)


def _stages():
    """Each of the ten spans at a distinct number of seconds."""
    return {s: 0.25 * (k + 1) for k, s in enumerate(spans.TRAJECTORY_SPANS)}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_reads_its_span(name):
    stages = _stages()
    span = name[:-len("_s.md")]
    assert run.reader(name)(_ctx(stages)) == pytest.approx(
        stages[span] / 2.5)


@pytest.mark.parametrize("name", SPAN_METRICS + ["untracked_s.md"])
def test_span_metric_none_without_its_source(name):
    span = name[:-len("_s.md")]
    stages = _stages()
    stages.pop(span, None)
    stages.pop("route", None)  # a parent without the new spans
    assert run.reader(name)(_ctx(stages)) is None
    assert run.reader(name)(_ctx(None)) is None
    assert run.reader(name)(_ctx(_stages(), frames=0)) is None


def test_untracked_is_the_window_less_the_spans():
    stages = _stages()  # 13.75 s in all
    got = run.reader("untracked_s.md")(_ctx(stages, window_s=15.0))
    assert got == pytest.approx((15.0 - 13.75) / 2.5)


def test_slot_fill_reads_the_program_counters(monkeypatch):
    fake = types.SimpleNamespace(tallies={"atoms": 2622 * 4,
                                          "slots": 2688 * 4})
    monkeypatch.setitem(sys.modules, spans.STAGESTATS, fake)
    read = run.reader("slot_fill.md")
    assert read(_ctx(_stages())) == pytest.approx(100.0 * 2622 / 2688)
    assert read(_ctx(None)) is None  # not a traced run
    fake.tallies = {}
    assert read(_ctx(_stages())) is None
    monkeypatch.setitem(sys.modules, spans.STAGESTATS,
                        types.SimpleNamespace())  # no counters at all
    assert read(_ctx(_stages())) is None
    monkeypatch.delitem(sys.modules, spans.STAGESTATS)
    assert read(_ctx(_stages())) is None
