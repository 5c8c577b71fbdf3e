"""`BatchedSasaEngine.warm_shapes` on the CPU: the reference's shapes, the
no-op on an engine without a card, how shapes, threads and ring entries
reach each chunk, and the port's bench calling it before its warm pass.
The launches themselves are the card's (tests/test_torch_cuda.py)."""

import concurrent.futures
import contextlib
import threading
from types import SimpleNamespace

import pytest
pytest.importorskip("torch")
import torch

from rustsasa_tpu.ops.engine import BatchedSasaEngine as RefEngine
from rustsasa_tpu_torch import bench
from rustsasa_tpu_torch.ops import engine


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_warm_shapes_equal_the_references():
    assert engine.BatchedSasaEngine._WARM_SHAPES == RefEngine._WARM_SHAPES
    assert len(RefEngine._WARM_SHAPES) == 9


@pytest.mark.parametrize("kwargs", [{}, {"threads": 1},
                                    {"shapes": [(4096, 16)], "threads": 4}])
def test_cpu_engine_returns_zero(kwargs, monkeypatch):
    calls = []
    monkeypatch.setattr(engine, "_warm_chunk", lambda *a: calls.append(a))
    eng = engine.BatchedSasaEngine(engine.SasaParams(), device="cpu")
    assert eng.warm_shapes(**kwargs) == 0.0
    assert calls == []


@pytest.fixture
def card_engine(monkeypatch):
    """make(n_entries, backend=) -> (engine, calls): a CPU engine whose
    ring claims CUDA entries (streams "s0", "s1", ...), with
    `_warm_chunk` recording (m, w, n_points, device, stream, thread) in
    place of the launches."""
    calls = []
    monkeypatch.setattr(
        engine, "_warm_chunk",
        lambda m, w, p, dev, stream: calls.append(
            (m, w, p, dev, stream, threading.current_thread().name)))

    def make(n_entries=1, backend="auto"):
        eng = engine.BatchedSasaEngine(engine.SasaParams(), backend=backend,
                                       device="cpu")
        eng.ring.devices = [torch.device("cuda", 0)] * n_entries
        eng.ring.streams = [f"s{i}" for i in range(n_entries)]
        monkeypatch.setattr(eng.ring, "stream", lambda entry: contextlib.nullcontext())
        return eng, calls
    return make


def test_serial_runs_every_shape_in_order_on_this_thread(card_engine):
    eng, calls = card_engine()
    shapes = [(4096, 16), (8192, 127), (524288, 32)]
    assert eng.warm_shapes(shapes, threads=1) >= 0.0
    main = threading.current_thread().name
    assert calls == [(m, w, 100, torch.device("cuda", 0), "s0", main)
                     for m, w in shapes]


def test_default_is_one_thread_a_shape(card_engine, monkeypatch):
    eng, calls = card_engine()
    pools = []

    class Pool(concurrent.futures.ThreadPoolExecutor):
        def __init__(self, max_workers=None, **kwargs):
            pools.append(max_workers)
            super().__init__(max_workers=max_workers, **kwargs)

    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", Pool)
    eng.warm_shapes()
    assert pools == [len(engine.BatchedSasaEngine._WARM_SHAPES)]
    assert sorted(c[:2] for c in calls) == sorted(
        engine.BatchedSasaEngine._WARM_SHAPES)
    assert threading.current_thread().name not in {c[5] for c in calls}
    pools.clear()
    eng.warm_shapes([(4096, 16), (8192, 24)], threads=2)
    assert pools == [2]


def test_every_ring_entry_warms_on_its_own_stream(card_engine):
    eng, calls = card_engine(n_entries=2)
    eng.warm_shapes([(4096, 16), (8192, 32)], threads=1)
    assert [(c[0], c[1], c[4]) for c in calls] == [
        (4096, 16, "s0"), (4096, 16, "s1"), (8192, 32, "s0"),
        (8192, 32, "s1")]


def test_list_backend_has_nothing_to_warm(card_engine):
    eng, calls = card_engine(backend="list")
    assert eng.warm_shapes() == 0.0 and calls == []


def test_bench_warms_the_shapes_before_its_warm_pass(tmp_path,
                                                     monkeypatch):
    """The bench record carries warm_shapes_s (0.0 on the CPU), and the
    shapes are warmed before the first corpus pass."""
    from rustsasa_tpu_torch import batch
    from rustsasa_tpu_torch.scripts import quality_gate

    order = []
    real_warm = engine.BatchedSasaEngine.warm_shapes

    def warm(self, *args, **kwargs):
        order.append("warm_shapes")
        return real_warm(self, *args, **kwargs)

    def process_directory(src, out_dir, options, fmt, **kwargs):
        order.append("pass")
        return SimpleNamespace(n_ok=1, n_files=1, errors=[])

    def build_corpus(corpus_dir):
        return 1, 100, 1

    gate = {"pass": True, "rmse": 45.0, "rows": []}
    monkeypatch.setattr(engine.BatchedSasaEngine, "warm_shapes", warm)
    monkeypatch.setattr(batch, "process_directory", process_directory)
    monkeypatch.setattr(bench, "build_corpus", build_corpus)
    monkeypatch.setattr(quality_gate, "run_gate", lambda device: gate)
    monkeypatch.setattr(quality_gate, "write_artifact", lambda g: None)
    record = bench.run("cpu", str(tmp_path), say=lambda msg: None)
    assert order == ["warm_shapes"] + ["pass"] * (bench.PASSES + 1)
    assert record["warm_shapes_s"] == 0.0
    assert list(record).index("warm_shapes_s") == list(record).index(
        "build_s") + 1
