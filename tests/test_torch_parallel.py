"""The port's scale-out layer against the JAX package's (CPU).

The reference runs on the conftest's 8-device virtual CPU mesh; the port
runs its plain-torch kernels on device lists of "cpu" entries.  Inputs
are the reference's own example batch (`__graft_entry__._example_batch`),
which the port's copy reproduces array for array.
"""

import os

import numpy as np
import pytest
pytest.importorskip("torch")
import torch

import __graft_entry__ as ref_graft
from rustsasa_tpu.ops.engine import _sasa_batched as ref_sasa_batched
from rustsasa_tpu.parallel import distributed as ref_dist
from rustsasa_tpu.parallel import mesh as ref_mesh

from rustsasa_tpu_torch import graft_entry
from rustsasa_tpu_torch.ops import engine, neighbors
from rustsasa_tpu_torch.parallel import distributed, mesh


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n, count", [(10, 3), (7, 1), (3, 4), (66, 2),
                                      (66, 4), (0, 2)])
def test_shard_files_equals_reference(n, count):
    files = [f"f{i:03d}" for i in range(n)]
    shards = [distributed.shard_files(files, i, count) for i in range(count)]
    assert shards == [ref_dist.shard_files(files, i, count)
                      for i in range(count)]
    assert sorted(sum(shards, [])) == files
    # Without a process group this process is rank 0 of 1.
    assert distributed.shard_files(files) == ref_dist.shard_files(files)


@pytest.mark.parametrize("total", [0.0, 1234.5, 1.0 / 3.0, 20268.004,
                                   123456789.123456789, 1e12 + 0.1])
def test_allreduce_metrics_single_process_bit_equal_reference(total):
    got = distributed.allreduce_metrics(10, 8, 2, total)
    want = ref_dist.allreduce_metrics(10, 8, 2, total)
    assert (got.n_files, got.n_ok, got.n_errors) == (
        want.n_files, want.n_ok, want.n_errors) == (10, 8, 2)
    assert np.float64(got.total_area).tobytes() == (
        np.float64(want.total_area).tobytes())


@pytest.mark.parametrize("b, n, n_points, seed", [(4, 256, 100, 0),
                                                  (8, 128, 100, 0),
                                                  (3, 64, 960, 7)])
def test_example_batch_identical_to_reference(b, n, n_points, seed):
    got = graft_entry._example_batch(b, n, n_points, seed)
    want = ref_graft._example_batch(b, n, n_points, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_sharded_step_matches_reference_mesh_and_unsharded():
    packed, gid, sphere = graft_entry._example_batch(b=8, n=128)
    ref_m = ref_mesh.make_mesh(8)
    ref_step = ref_mesh.make_sharded_sasa(ref_m, k=64, n_points=100)
    ref_sasa, ref_total, ref_mc = ref_step(
        ref_mesh.put_batch_sharded(ref_m, packed),
        ref_mesh.put_batch_sharded(ref_m, gid), sphere)

    devices = ["cpu"] * 8
    step = mesh.make_sharded_sasa(devices, k=64, n_points=100)
    sasa, total, max_count = step(mesh.put_batch_sharded(devices, packed),
                                  mesh.put_batch_sharded(devices, gid),
                                  sphere)
    assert sasa.shape == (8, 128) and total.shape == max_count.shape == (1,)
    np.testing.assert_allclose(sasa.numpy(), np.asarray(ref_sasa), atol=1e-3)
    assert float(total[0]) == pytest.approx(float(ref_total[0]), rel=1e-5)
    assert int(max_count[0]) == int(ref_mc[0])

    whole, whole_mc = neighbors._sasa_batched(
        *(torch.from_numpy(a) for a in (packed, gid, sphere)),
        k=64, n_points=100, probe=1.4)
    assert torch.equal(sasa, whole)
    assert float(total[0]) == float(whole.double().sum())
    assert int(max_count[0]) == int(whole_mc)
    # Host arrays are sharded by the step itself.
    again = step(packed, gid, sphere)
    assert all(torch.equal(a, b) for a, b in zip(again, (sasa, total,
                                                         max_count)))


def test_sharded_step_needs_a_dividing_batch():
    packed, gid, sphere = graft_entry._example_batch(b=3, n=64)
    step = mesh.make_sharded_sasa(["cpu", "cpu"], k=64, n_points=100)
    with pytest.raises(ValueError, match="does not divide"):
        step(packed, gid, sphere)


def test_make_mesh():
    assert mesh.make_mesh(device_type="cpu") == [torch.device("cpu")]
    assert mesh.make_mesh(1, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="1 visible"):
        mesh.make_mesh(2, "cpu")  # never padded with repeats
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.make_mesh()


def test_entry_matches_reference():
    import jax

    fn, args = graft_entry.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    sasa, max_count = fn(*args)
    ref_fn, ref_args = ref_graft.entry()
    ref_sasa, ref_mc = jax.jit(ref_fn)(*ref_args)
    assert sasa.shape == args[0].shape[:2]
    np.testing.assert_allclose(sasa.numpy(), np.asarray(ref_sasa), atol=1e-3)
    assert int(max_count) == int(ref_mc)
    # The reference's direct call, unjitted, too.
    ref_direct, _ = ref_sasa_batched(*ref_args, k=64, n_points=100,
                                     probe=1.4, backend="xla")
    np.testing.assert_allclose(sasa.numpy(), np.asarray(ref_direct),
                               atol=1e-3)


def test_dryrun_multichip_on_cpu_entries(capsys):
    graft_entry.dryrun_multichip(["cpu", "cpu"])
    assert "fused chunks per entry [1, 1]" in capsys.readouterr().out


def _structures(sizes, seed):
    rng = np.random.default_rng(seed)
    return [((rng.uniform(0, 25.0, (n, 3)) + 40.0).astype(np.float32),
             rng.choice(np.array([1.4, 1.6, 1.8], np.float32), n),
             np.arange(n, dtype=np.int32)) for n in sizes]


def test_compute_fused_over_two_entries_equals_one(monkeypatch):
    # A budget of 2 tiles: five chunks, dealt 0, 1, 0, 1, 0.
    monkeypatch.setattr(engine, "CHUNK_SLOT_BUDGET", 256)
    structures = _structures([300, 100, 250, 150, 200], seed=3)
    one = engine._compute_fused(structures, probe=1.4, n_points=100,
                                ring=engine.DeviceRing(["cpu"]),
                                routes=engine.RouteCounts(1))
    two = engine._compute_fused(structures, probe=1.4, n_points=100,
                                ring=engine.DeviceRing(["cpu", "cpu"]),
                                routes=engine.RouteCounts(2))
    assert one.routes.entries == [5]
    assert two.routes.entries == [3, 2]
    for a, b in zip(one.collect(), two.collect()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_enqueue_calls_alternate_entries():
    structures = _structures([200, 150], seed=4)
    eng = engine.BatchedSasaEngine(devices=["cpu", "cpu"])
    assert eng.device == torch.device("cpu") and len(eng.ring) == 2
    got = [eng.enqueue([s]).collect()[0] for s in structures * 2]
    assert eng.routes.entries == [2, 2]
    assert eng.chunks_dispatched == 4
    want = engine.BatchedSasaEngine(device="cpu").compute(structures)
    for g, w in zip(got, want * 2):
        np.testing.assert_array_equal(g, w)


def test_device_ring_counter_under_threads():
    """Concurrent takes deal every entry the same number of chunks: a lost
    update of the counter, or of the per-entry counts, would unbalance
    them."""
    import sys
    import threading

    ring = engine.DeviceRing(["cpu"] * 3)
    routes = engine.RouteCounts(len(ring))

    def work():
        for _ in range(1500):
            routes.add("q13", ring.take())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert routes.entries == [8000, 8000, 8000]
    assert routes.counts["q13"] == 24000


def test_resolve_devices():
    cpu = torch.device("cpu")
    assert engine.resolve_devices("cpu") == [cpu]
    assert engine.resolve_devices(["cpu", cpu]) == [cpu, cpu]
    with pytest.raises(ValueError, match="empty"):
        engine.resolve_devices([])
    with pytest.raises(ValueError, match="unsupported"):
        engine.resolve_devices(["meta"])
    with pytest.raises(ValueError, match="not both"):
        engine.BatchedSasaEngine(device="cpu", devices=["cpu"])
    if not torch.cuda.is_available():
        for devices in ("cuda", ["cuda:0", "cuda:0"], ["cpu", "cuda"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                engine.BatchedSasaEngine(devices=devices)


class _FakeStream:
    """Stands in for torch.cuda.Stream on a host without a card."""

    def __init__(self, device=None):
        self.device = device


@pytest.fixture
def three_visible_cards(monkeypatch):
    """torch.cuda reports three cards; no kernel runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    return [torch.device("cuda", i) for i in range(3)]


class _Built(Exception):
    """Raised by a recording engine once it is built."""


def _recording_engine(monkeypatch, module, raise_after=False):
    """Patches `module`'s BatchedSasaEngine with a subclass that keeps
    every instance it builds (and raises _Built after one when asked)."""
    built = []

    class Recording(engine.BatchedSasaEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)
            if raise_after:
                raise _Built

    monkeypatch.setattr(module, "BatchedSasaEngine", Recording)
    return built


def test_default_engine_deals_over_every_visible_card(three_visible_cards):
    for eng in (engine.BatchedSasaEngine(),
                engine.BatchedSasaEngine(device="cuda"),
                engine.BatchedSasaEngine(device=torch.device("cuda"))):
        assert eng.ring.devices == three_visible_cards
        assert eng.device == three_visible_cards[0]
        assert eng.routes.entries == [0, 0, 0]
        assert all(isinstance(s, _FakeStream) for s in eng.ring.streams)
        assert [eng.ring.take() for _ in range(4)] == [0, 1, 2, 0]


@pytest.mark.parametrize("device", ["cuda:1", torch.device("cuda", 1)])
def test_indexed_cuda_is_one_card(three_visible_cards, device):
    eng = engine.BatchedSasaEngine(device=device)
    assert eng.ring.devices == [three_visible_cards[1]]
    assert eng.ring.streams == [None]


def test_entry_points_default_to_every_visible_card(three_visible_cards,
                                                    monkeypatch, tmp_path):
    from rustsasa_tpu_torch import SASAOptions, batch, trajectory

    built = _recording_engine(monkeypatch, batch)
    (tmp_path / "in").mkdir()
    report = batch.process_directory(str(tmp_path / "in"),
                                     str(tmp_path / "out"), SASAOptions(),
                                     "json", progress=False)
    assert report.n_files == 0 and len(built) == 1
    assert built[0].ring.devices == three_visible_cards

    built = _recording_engine(monkeypatch, trajectory, raise_after=True)
    example = os.path.join("tests", "data", "pdbs", "example.cif")
    with pytest.raises(_Built):
        trajectory.compute_trajectory_sasa(example, str(tmp_path / "t.dcd"))
    assert built[0].ring.devices == three_visible_cards


def test_default_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kwargs in ({}, {"device": "cuda"}, {"devices": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine.BatchedSasaEngine(**kwargs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.BatchedSasaEngine()


def test_process_directory_distributed_single_process(reference_data_dir,
                                                      tmp_path):
    from rustsasa_tpu_torch import (BatchedSasaEngine, Level, SASAOptions,
                                    SasaParams, process_directory)

    src = str(reference_data_dir / "pdbs")
    options = SASAOptions(level=Level.PROTEIN, device="cpu")
    g = distributed.process_directory_distributed(
        src, str(tmp_path / "dist"), options, "json", progress=False,
        engine=BatchedSasaEngine(SasaParams(), device="cpu"))
    assert (g.n_files, g.n_ok, g.n_errors) == (3, 3, 0)
    assert g.total_area > 0.0 and g.shard_s > 0.0
    report = process_directory(
        src, str(tmp_path / "one"), options, "json", progress=False,
        engine=BatchedSasaEngine(SasaParams(), device="cpu"))
    assert g.total_area == distributed.allreduce_metrics(
        3, 3, 0, report.total_area).total_area
    names = sorted(os.listdir(tmp_path / "one"))
    assert sorted(os.listdir(tmp_path / "dist")) == names and len(names) == 3
    for name in names:
        assert (tmp_path / "dist" / name).read_bytes() == (
            tmp_path / "one" / name).read_bytes()
