"""The harness end to end at a tiny size on the CPU, and without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import readers, run

from .conftest import CELLS


def test_cli_without_a_card_exits_nonzero_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "md960.traj",
         "--seed", "2147483913", "--seconds", "1", "--trace", "0"],
        cwd=run.REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cpu_run_is_correct_and_reports_no_device_metric(tiny_run, cell,
                                                              trace):
    rc, result = tiny_run(cell, trace=trace)
    assert rc == 0 and result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["metrics"] == {}
    assert result["device"]["platform"] == "cpu"
    assert list(result)[-1] == "checks"
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    assert run.forbidden_modules() == []


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rustsasa_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert run.forbidden_modules() == ["jaxlib"]


def _ctx(**kw):
    base = dict(setup_s=12.5, window_s=10.0, passes=4, work={}, stages=None,
                trace=None, geometry=None)
    base.update(kw)
    return run.Context(**base)


def test_readers_return_nothing_without_a_source():
    ctx = _ctx()
    for fn in (readers.frames_per_s, readers.idle_share,
               readers.kernels_roofline, readers.pack_s_per_kframe,
               readers.load_wait_s_per_pass, readers.batch_matoms_per_s):
        assert fn(ctx) is None
    assert readers.setup_seconds(ctx) == 12.5


def test_readers_arithmetic():
    trace = {"window_s": 10.0, "busy_s": 2.5, "kernel_s": 2.0}
    ctx = _ctx(work={"frames": 10000, "atoms": 8e6}, trace=trace,
               stages={"pack": 0.5, "load_wait": 2.0},
               geometry=lambda: (33.5e12 * 0.5, 1.0))
    assert readers.frames_per_s(ctx) == 1000.0
    assert readers.batch_matoms_per_s(ctx) == 0.8
    assert readers.idle_share(ctx) == 75.0
    assert readers.kernels_roofline(ctx) == 25.0
    assert readers.pack_s_per_kframe(ctx) == 0.05
    assert readers.load_wait_s_per_pass(ctx) == 0.5


def test_trace_summary():
    from benchmark import trace

    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "stage.load_wait",
         "ts": 0, "dur": 40, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "stage.emit_wait",
         "ts": 60, "dur": 40, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 40, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 45, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 85,
         "dur": 30},
    ]
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["kernel_s"] == pytest.approx(20e-6)
    assert s["idle_gaps"][0] == ["load_wait", pytest.approx(40e-6)]
    assert s["idle_gaps"][1] == ["emit_wait", pytest.approx(30e-6)]
    assert [k for k, _ in s["device_ops"]] == ["copy", "k1", "k2"]
    assert trace.summarize(ev[1:]) is None


@pytest.mark.gpu
def test_cell_runs_on_the_card(tmp_path):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "md960.traj",
         "--seed", "2147483999", "--seconds", "2", "--trace", "1"],
        cwd=run.REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
