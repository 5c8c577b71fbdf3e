"""The PyTorch port's engine against the JAX reference engine (CPU).

The reference runs as its own tests run it (`backend="fused_interpret"`,
f32 readback); the port runs its plain-torch kernels with device="cpu".
Both reconstruct SASA from the same occlusion counts, so the per-atom
results must be identical arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")
import torch

import rustsasa_tpu.ops.engine as ref_engine
import rustsasa_tpu_torch.ops.engine as port_engine

RADII = np.array([1.4, 1.55, 1.6, 1.7, 1.8, 1.9], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and each process's spinning OpenMP threads would fight the
    others' for the same cores (a 1 s test took 300 s that way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _structure(n, seed, spread=25.0, gids=True):
    rng = np.random.default_rng(seed)
    coords = (rng.uniform(0, spread, (n, 3)) + 40.0).astype(np.float32)
    radii = rng.choice(RADII, n)
    return coords, radii, (np.arange(n, dtype=np.int32) if gids else None)


def _reference(structures, n_points=100):
    return ref_engine.BatchedSasaEngine(
        ref_engine.SasaParams(n_points=n_points),
        backend="fused_interpret", readback_dtype=jnp.float32,
    ).compute(structures)


def _port(structures, n_points=100):
    return port_engine.BatchedSasaEngine(
        port_engine.SasaParams(n_points=n_points), device="cpu"
    ).compute(structures)


def _assert_identical(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_engine_mixed_sizes_and_q16_split_match_reference():
    # Mixed sizes, an empty structure, gids omitted on one, and one
    # structure over 100 A that splits onto the q16 wire.
    structures = [
        _structure(90, 1),
        _structure(400, 2, gids=False),
        (np.zeros((0, 3), np.float32), np.zeros(0, np.float32), None),
        _structure(260, 3, spread=120.0),
        _structure(1300, 4),
    ]
    _assert_identical(_port(structures), _reference(structures))


def test_engine_chunk_split_matches_reference(monkeypatch):
    # A slot budget of 4 tiles forces several chunks on both sides.
    monkeypatch.setattr(ref_engine, "_FUSED_ATOM_BUDGET", 512)
    monkeypatch.setattr(port_engine, "CHUNK_SLOT_BUDGET", 512)
    structures = [_structure(n, 10 + n) for n in (130, 300, 60, 250, 500)]
    _assert_identical(_port(structures), _reference(structures))


@pytest.mark.parametrize("n_points", [60, 256])
def test_calculate_sasa_internal_matches_reference(n_points):
    coords, radii, _ = _structure(500, 20)
    gids = np.arange(1000, 1500)  # int64, refactorized on both sides
    want = ref_engine.calculate_sasa_internal(
        coords, radii, group_ids=gids, n_points=n_points,
        backend="fused_interpret",
    )
    got = port_engine.calculate_sasa_internal(
        coords, radii, group_ids=gids, n_points=n_points, device="cpu"
    )
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any()


def test_enqueue_returns_counts_views():
    structures = [_structure(200, 30), _structure(50, 31)]
    handle = port_engine.BatchedSasaEngine(device="cpu").enqueue(structures)
    views = handle.collect_views()
    assert all(isinstance(v, port_engine.CountsView) for v in views)
    assert views[0].counts.dtype == np.uint8
    assert [v.n for v in views] == [200, 50]


def _copies(base, n_copies, spacing=40.0):
    """n_copies translated copies of one structure on a 6 x 6 x 4 grid:
    many tiles, each culled to its neighbours, within the q16 extent."""
    coords, radii, _ = base
    grid = np.stack(np.meshgrid(np.arange(6), np.arange(6), np.arange(4),
                                indexing="ij"), -1)
    shifts = grid.reshape(-1, 3)[:n_copies].astype(np.float32) * spacing
    big = (coords[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    return big, np.tile(radii, n_copies), None


def _assert_within_point_flips(got, want, radii, n_points=100, flips=2):
    """Per atom at most `flips` sphere points apart (the bound of
    __graft_entry__.py), each worth 4 pi r_eff^2 / n_points."""
    point = 4.0 * np.pi * (radii.astype(np.float64) + 1.4) ** 2 / n_points
    np.testing.assert_array_less(np.abs(got - want), flips * point + 1e-3)


def _far_apart(n, seed):
    """Two clusters 1,400 A apart: beyond the q16 wire's 1,300 A extent."""
    coords, radii, gids = _structure(n, seed)
    coords = coords.copy()
    coords[n // 2:, 0] += 1400.0
    return coords, radii, gids


def _shared_gids(n, seed):
    """Alt-loc-style collision of dense ids (max < n-1)."""
    coords, radii, gids = _structure(n, seed)
    gids = gids.copy()
    gids[-1] = gids[0]
    return coords, radii, gids


def _over_127_tiles():
    coords, radii, gids = _copies(_structure(128, 42), 129)
    assert -(-coords.shape[0] // 128) == 129
    return coords, radii, gids


@pytest.mark.parametrize("case, routes", [
    pytest.param("shared_gids", {"q13": 1, "f32": 1}, id="shared_gids"),
    pytest.param("over_1300_A", {"q13": 1, "f32": 1}, id="over_1300_A"),
    pytest.param("over_127_tiles", {"q13": 1, "host_q16": 1},
                 id="over_127_tiles"),
    pytest.param("mixed", {"q13": 1, "f32": 2}, id="mixed"),
])
def test_ineligible_structure_raises(case, routes):
    """Structures the banded wires cannot take once raised
    UnsupportedInSlice; now each takes the wire the reference gives it
    and matches the reference.  In the mixed chunk the shared ids send
    the 129-tile structure down the f32 wire with them, and the
    far-apart one takes it alone after the banded wires refuse it."""
    small = _structure(100, 41)
    structures = {
        "shared_gids": lambda: [small, _shared_gids(300, 40)],
        "over_1300_A": lambda: [small, _far_apart(300, 43)],
        "over_127_tiles": lambda: [small, _over_127_tiles()],
        "mixed": lambda: [small, _shared_gids(300, 40), _far_apart(300, 43),
                          _over_127_tiles(), _structure(60, 44)],
    }[case]()
    engine = port_engine.BatchedSasaEngine(device="cpu")
    got = engine.compute(structures)
    want = _reference(structures)
    assert engine.routes.counts == dict(
        port_engine.RouteCounts().counts, **routes
    )
    if case != "over_127_tiles":
        _assert_identical(got, want)
        return
    _assert_identical(got[:1], want[:1])
    # XLA-CPU contracts the reference's host-cull q16 dequant
    # (q * scale + origin) into an FMA, which moves boundary points; the
    # port rounds the multiply and the add separately, as the reference
    # is written.  Counts on identical planes are byte-equal
    # (tests/test_torch_fused_kernel.py); here, at most 2 point flips.
    _assert_within_point_flips(got[1], want[1], structures[1][1])


def test_host_cull_overflow_falls_back_to_list_path(monkeypatch):
    # A structure whose host j-lists overflow (the packer reports it as
    # failed) is re-run on the list path, as the reference re-runs it on
    # its XLA list path.
    structures = [_shared_gids(200, 45), _shared_gids(150, 46)]
    pack = port_engine.fused_kernel.pack_structures

    def fail_first(triples, probe, n_points):
        planes, jlist, offsets, failed = pack(triples, probe, n_points)
        return planes, jlist, [None] + offsets[1:], [0]

    monkeypatch.setattr(port_engine.fused_kernel, "pack_structures",
                        fail_first)
    engine = port_engine.BatchedSasaEngine(device="cpu")
    handle = engine.enqueue(structures)
    views = handle.collect_views()
    assert isinstance(views[0], np.ndarray) and callable(views[1])
    got = [views[0], views[1]()]
    assert engine.routes.counts["f32"] == engine.routes.counts["list"] == 1
    want = ref_engine.BatchedSasaEngine(backend="xla").compute(structures)
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)
    np.testing.assert_array_equal(got[1], _reference(structures)[1])


def test_too_many_points_raises():
    """5,000 points exceed the count kernel's sphere.  Once raised
    UnsupportedInSlice; now "auto" takes the list path, held against the
    reference's list path ("xla")."""
    coords, radii, gids = _structure(50, 60)
    engine = port_engine.BatchedSasaEngine(
        port_engine.SasaParams(n_points=5000), device="cpu"
    )
    assert engine.backend == "list"
    got = engine.compute([(coords, radii, gids)])
    want = ref_engine.BatchedSasaEngine(
        ref_engine.SasaParams(n_points=5000), backend="xla"
    ).compute([(coords, radii, gids)])
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)
    assert engine.routes.counts["list"] == 1


def test_backend_resolution():
    resolve = port_engine.resolve_backend
    assert resolve("auto", 2048) == "fused"
    assert resolve("auto", 2049) == "list"
    assert resolve("list", 100) == "list"
    with pytest.raises(ValueError, match="backend='list'"):
        resolve("fused", 5000)
    with pytest.raises(ValueError, match="not one of"):
        resolve("xla", 100)


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_engine.BatchedSasaEngine(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_engine.calculate_sasa_internal(*_structure(10, 50)[:2])
