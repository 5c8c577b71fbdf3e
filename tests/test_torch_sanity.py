"""Analytic geometry tests of the port, on the CPU (the plain-torch
kernels).

The port's counterpart of tests/test_sanity.py (reference:
tests/sanity.rs): 50,000 sphere points, 0.5% relative tolerance, exact
sphere/spherical-cap formulas.  At 50,000 points the engine takes the
neighbor-list path.
"""

import math

import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from rustsasa_tpu_torch import calculate_sasa_internal

PROBE = 1.4
N_POINTS = 50_000
RTOL = 0.005


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sasa(atoms, **kw):
    coords = np.array([a[:3] for a in atoms], dtype=np.float32)
    radii = np.array([a[3] for a in atoms], dtype=np.float32)
    return calculate_sasa_internal(
        coords, radii, probe_radius=PROBE, n_points=N_POINTS, device="cpu",
        **kw
    )


def sphere_area(r):
    return 4.0 * math.pi * r * r


def test_single_sphere():
    out = sasa([(0.0, 0.0, 0.0, 2.0)])
    assert out[0] == pytest.approx(sphere_area(3.4), rel=RTOL)


def test_two_non_overlapping_spheres():
    out = sasa([(0, 0, 0, 2.0), (10, 0, 0, 2.0)])
    expected = sphere_area(3.4)
    assert out[0] == pytest.approx(expected, rel=RTOL)
    assert out[1] == pytest.approx(expected, rel=RTOL)
    assert float(out.sum()) == pytest.approx(2 * expected, rel=RTOL)


def test_two_overlapping_spheres():
    r = 2.0 + PROBE
    dist = 4.0
    out = sasa([(0, 0, 0, 2.0), (dist, 0, 0, 2.0)])
    x = dist / 2.0
    h_buried = r - x
    expected = sphere_area(r) - 2.0 * math.pi * r * h_buried
    assert out[0] == pytest.approx(expected, rel=RTOL)
    assert out[1] == pytest.approx(expected, rel=RTOL)


def test_contained_sphere():
    out = sasa([(0, 0, 0, 10.0), (2.0, 0, 0, 2.0)])
    assert out[0] == pytest.approx(sphere_area(11.4), rel=RTOL)
    assert out[1] == pytest.approx(0.0, abs=RTOL)


def test_three_spheres_linear_chain():
    dist = 5.0
    out = sasa([(0, 0, 0, 2.0), (dist, 0, 0, 2.0), (2 * dist, 0, 0, 2.0)])
    r = 2.0 + PROBE
    h_buried = r - dist / 2.0
    cap = 2.0 * math.pi * r * h_buried
    expected_end = sphere_area(r) - cap
    expected_mid = sphere_area(r) - 2.0 * cap
    assert out[0] == pytest.approx(expected_end, rel=RTOL)
    assert out[2] == pytest.approx(expected_end, rel=RTOL)
    assert out[1] == pytest.approx(expected_mid, rel=RTOL)


def test_empty_atom_list():
    out = calculate_sasa_internal(
        np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
        probe_radius=PROBE, n_points=N_POINTS, device="cpu",
    )
    assert out.shape == (0,)


def test_same_group_id_atoms_do_not_occlude():
    # Two coincident atoms sharing a group id must not shadow each other
    # (reference: Atom.id equality skip, lib.rs:124).
    out = sasa(
        [(0, 0, 0, 2.0), (0.5, 0, 0, 2.0)], group_ids=np.array([7, 7])
    )
    expected = sphere_area(3.4)
    assert out[0] == pytest.approx(expected, rel=RTOL)
    assert out[1] == pytest.approx(expected, rel=RTOL)
