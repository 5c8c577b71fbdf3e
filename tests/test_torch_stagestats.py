"""The port's host spans and counters (`utils/stagestats.py`), on the CPU.

Disabled, a span and a tally keep nothing, take no lock and import no
torch.  Enabled, they sum exactly from many threads and put
`stage.<name>` annotations on torch.profiler's timeline with no help
from the benchmark harness.  On the trajectory path every step of a pass
falls under one of ten spans, leaves that do not overlap on the calling
thread, and the dispatch boundary counts real atoms against slots.
"""

import gzip
import json
import sys
import threading
import time

import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from rustsasa_tpu_torch import SASAOptions
from rustsasa_tpu_torch.io.read import read_structure
from rustsasa_tpu_torch.levels import Level
from rustsasa_tpu_torch.trajectory import compute_trajectory_sasa, write_dcd
from rustsasa_tpu_torch.utils import stagestats

SMALLEST = "tests/data/freesasa_pdbs/2drt.pdb.gz"
TRAJECTORY_SPANS = {
    "topology", "dcd_read", "gather", "route", "pack", "h2d", "launch",
    "device_wait", "unpack", "frame_sums",
}


class _NoLock:
    """A lock that fails the test if anything takes it."""

    def __enter__(self):
        raise AssertionError("the disabled path took the lock")

    def __exit__(self, *exc):
        return False


class _CountingLock:
    def __init__(self):
        self._lock = threading.Lock()
        self.taken = 0

    def __enter__(self):
        self._lock.acquire()
        self.taken += 1

    def __exit__(self, *exc):
        self._lock.release()
        return False


@pytest.fixture
def clean():
    """Empty stagestats around a test; requested before `monkeypatch`, so
    that its teardown runs after the patches are undone."""
    stagestats.reset()
    yield
    stagestats.reset()


def _user_annotations(trace_path):
    with open(trace_path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("stage.")]


def test_disabled_keeps_nothing_takes_no_lock_imports_no_torch(
        clean, monkeypatch):
    monkeypatch.setattr(stagestats, "enabled", False)
    monkeypatch.setattr(stagestats, "_lock", _NoLock())
    # Any import of torch.profiler now raises.
    monkeypatch.setitem(sys.modules, "torch.profiler", None)
    for _ in range(3):
        with stagestats.stage("pack"):
            pass
        stagestats.tally("atoms", 7)
    assert dict(stagestats.totals) == {}
    assert dict(stagestats.counts) == {}
    assert dict(stagestats.tallies) == {}


def test_enabled_sums_under_the_lock(clean, monkeypatch):
    monkeypatch.setattr(stagestats, "enabled", True)
    lock = _CountingLock()
    monkeypatch.setattr(stagestats, "_lock", lock)
    with stagestats.stage("pack"):
        time.sleep(0.002)
    stagestats.tally("slots", 128)
    assert lock.taken == 2
    assert stagestats.counts["pack"] == 1
    assert stagestats.totals["pack"] >= 0.002
    assert stagestats.tallies["slots"] == 128
    report = stagestats.report(wall=1.0)
    assert "pack" in report and "slots" in report and "128" in report
    stagestats.reset()
    assert not stagestats.totals and not stagestats.tallies


def test_threads_lose_no_update(clean, monkeypatch):
    monkeypatch.setattr(stagestats, "enabled", True)
    n_threads, n_spans = 8, 1000
    start = threading.Barrier(n_threads)

    def work(k):
        start.wait(timeout=30)
        for i in range(n_spans):
            with stagestats.stage("span"):
                pass
            stagestats.tally("n", k + 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert stagestats.counts["span"] == n_threads * n_spans
    assert stagestats.tallies["n"] == n_spans * sum(range(1, n_threads + 1))
    assert stagestats.totals["span"] > 0.0


def test_span_lands_on_the_profiler_timeline(clean, monkeypatch, tmp_path):
    monkeypatch.setattr(stagestats, "enabled", True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with stagestats.stage("probe"):
            torch.ones(16).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in _user_annotations(path)]
    assert names == ["stage.probe"]


def test_q13_declined_counts_the_declined_chunk(clean, monkeypatch):
    """A chunk the q13 packer declines tallies its structures once: the
    sub-chunk over 100 A goes to the q16 wire with no second attempt, and
    the sub-chunk that fits is packed on q13.  A chunk it takes tallies
    nothing."""
    from rustsasa_tpu_torch.ops import engine

    monkeypatch.setattr(stagestats, "enabled", True)

    def structure(n, seed, spread):
        rng = np.random.default_rng(seed)
        coords = rng.uniform(0, spread, (n, 3)).astype(np.float32)
        return coords, np.full(n, 1.7, np.float32), None

    sasa = engine.BatchedSasaEngine(device="cpu")
    sasa.compute([structure(200, 1, 25.0), structure(60, 2, 25.0)])
    assert not stagestats.tallies.get("q13_declined")
    sasa.compute([structure(200, 3, 120.0), structure(150, 4, 130.0),
                  structure(60, 5, 25.0)])
    assert stagestats.tallies["q13_declined"] == 3
    assert sasa.routes.counts["q13"] == 2
    assert sasa.routes.counts["q16"] == 1


def _traced_pass(tmp, device):
    """compute_trajectory_sasa on 2drt, 4 jittered frames in blocks of 2,
    on `device` with stagestats enabled, under torch.profiler: the spans'
    totals, the tallies, the profiler's stage annotations and device
    kernels, the pass's wall seconds and the selected atom count."""
    top = tmp / "2drt.pdb"
    with gzip.open(SMALLEST, "rb") as f:
        top.write_bytes(f.read())
    base = read_structure(str(top)).atoms.coords.astype(np.float32)
    rng = np.random.default_rng(0)
    frames = base[None] + rng.normal(0.0, 0.3, (4, *base.shape)).astype(
        np.float32)
    dcd = tmp / "t.dcd"
    write_dcd(str(dcd), frames)
    opts = SASAOptions(level=Level.RESIDUE, device=device)
    n_sel = opts.build_selection(read_structure(str(top))).coords.shape[0]
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)

    was, threads = stagestats.enabled, torch.get_num_threads()
    stagestats.enabled = True
    torch.set_num_threads(1)
    stagestats.reset()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            result = compute_trajectory_sasa(str(top), str(dcd), opts,
                                             block=2)
            wall = time.perf_counter() - t0
        out = {"totals": dict(stagestats.totals),
               "counts": dict(stagestats.counts),
               "tallies": dict(stagestats.tallies), "wall": wall,
               "n_sel": n_sel, "n_frames": result.n_frames}
    finally:
        stagestats.enabled = was
        stagestats.reset()
        torch.set_num_threads(threads)
    path = tmp / "trace.json"
    prof.export_chrome_trace(str(path))
    out["annotations"] = _user_annotations(path)
    with open(path, encoding="utf-8") as f:
        out["kernels"] = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return out


@pytest.fixture(scope="module")
def traced_pass(tmp_path_factory):
    return _traced_pass(tmp_path_factory.mktemp("stagestats"), "cpu")


def test_trajectory_pass_has_every_span(traced_pass):
    assert traced_pass["n_frames"] == 4
    assert set(traced_pass["totals"]) == TRAJECTORY_SPANS
    names = {e["name"] for e in traced_pass["annotations"]}
    assert names == {f"stage.{s}" for s in TRAJECTORY_SPANS}
    # Once a pass; a read for each of the two blocks and the end.
    assert traced_pass["counts"]["topology"] == 1
    assert traced_pass["counts"]["dcd_read"] == 3
    assert traced_pass["counts"]["gather"] == 2


def _assert_leaves(annotations):
    assert len({e["tid"] for e in annotations}) == 1
    spans = sorted(annotations, key=lambda e: float(e["ts"]))
    for a, b in zip(spans, spans[1:]):
        assert float(b["ts"]) >= float(a["ts"]) + float(a["dur"]), (a, b)


def test_trajectory_spans_do_not_overlap(traced_pass):
    _assert_leaves(traced_pass["annotations"])


def test_trajectory_spans_cover_the_pass(traced_pass):
    tracked = sum(traced_pass["totals"].values())
    assert tracked <= traced_pass["wall"]
    assert tracked >= 0.8 * traced_pass["wall"]


def test_trajectory_tallies_atoms_and_slots(traced_pass):
    n = traced_pass["n_sel"]
    assert traced_pass["tallies"] == {
        "atoms": 4 * n, "slots": 4 * (-(-n // 128) * 128)}


@pytest.mark.gpu
def test_trajectory_spans_on_the_card(tmp_path):
    """The same pass on the card: the ten spans on the profiler's clock
    beside the count kernels, leaves on the calling thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = _traced_pass(tmp_path, "cuda")
    assert got["n_frames"] == 4
    assert {e["name"] for e in got["annotations"]} == {
        f"stage.{s}" for s in TRAJECTORY_SPANS}
    _assert_leaves(got["annotations"])
    assert any("fused_count" in e["name"] for e in got["kernels"])
    n = got["n_sel"]
    assert got["tallies"] == {"atoms": 4 * n, "slots": 4 * (-(-n // 128) * 128)}
