"""The PyTorch port's engine against the JAX reference engine (CPU).

The reference runs as its own tests run it (`backend="fused_interpret"`,
f32 readback); the port runs its plain-torch kernels with device="cpu".
Both reconstruct SASA from the same occlusion counts, so the per-atom
results must be identical arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustsasa_tpu.ops.engine as ref_engine
import rustsasa_tpu_torch.ops.engine as port_engine
from rustsasa_tpu_torch import UnsupportedInSlice

RADII = np.array([1.4, 1.55, 1.6, 1.7, 1.8, 1.9], np.float32)


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


@pytest.mark.parametrize("case", ["shared_gids", "over_127_tiles"])
def test_ineligible_structure_raises(case):
    coords, radii, gids = _structure(300, 40)
    if case == "shared_gids":
        # Alt-loc-style collision of dense ids (max < n-1): the reference
        # sends it down the host-cull f32 wire.
        gids = gids.copy()
        gids[-1] = gids[0]
    else:
        coords = np.tile(coords, (55, 1))  # 16,500 atoms = 129 tiles
        radii = np.tile(radii, 55)
        gids = None
    engine = port_engine.BatchedSasaEngine(device="cpu")
    with pytest.raises(UnsupportedInSlice, match="ROADMAP"):
        engine.enqueue([_structure(100, 41), (coords, radii, gids)])


def test_too_many_points_raises():
    engine = port_engine.BatchedSasaEngine(
        port_engine.SasaParams(n_points=5000), device="cpu"
    )
    with pytest.raises(UnsupportedInSlice, match="neighbor-list"):
        engine.compute([_structure(50, 60)])


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_engine.BatchedSasaEngine(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_engine.calculate_sasa_internal(*_structure(10, 50)[:2])
