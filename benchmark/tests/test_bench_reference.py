"""The plain reference against closed forms, on the CPU."""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

from benchmark import reference, run, structures


def test_isolated_sphere_is_4_pi_r2():
    for p in (100, 960):
        sasa = reference.atom_sasa(np.zeros((1, 3)), [1.8], 1.4, p)
        assert sasa[0] == pytest.approx(4 * math.pi * 3.2 ** 2, rel=1e-12)


def _caps(d, r1, r2):
    """Analytic exposed areas of two overlapping spheres at distance d."""
    out = []
    for a, b in ((r1, r2), (r2, r1)):
        h = a - (d * d + a * a - b * b) / (2 * d)
        out.append(4 * math.pi * a * a - 2 * math.pi * a * h)
    return out


@pytest.mark.parametrize("d", [2.0, 3.5, 5.0])
def test_two_spheres_match_analytic_area(d):
    r1, r2, probe = 1.6, 2.0, 1.4
    coords = np.array([[0.0, 0.0, 0.0], [d, 0.3, -0.2]])
    d = float(np.linalg.norm(coords[1]))
    sasa = reference.atom_sasa(coords, [r1, r2], probe, 20000)
    want = _caps(d, r1 + probe, r2 + probe)
    # The spiral's quadrature error on a cap at 20,000 points.
    assert sasa == pytest.approx(want, rel=2e-3)


def test_far_atoms_do_not_bury():
    coords = np.array([[0.0, 0, 0], [6.5, 0, 0]])
    free = reference.free_points(coords, [1.6, 1.6], 1.4, 960)
    assert free.tolist() == [960, 960]


def test_control_precision_moves_the_answer():
    path = os.path.join(run.REPO, "benchmark", "data", "freesasa",
                        "2drt.pdb.gz")
    sel = structures.select(structures.read_atoms(path))
    f64 = reference.free_points(sel.coords, sel.radii, 1.4, 100)
    bf16 = reference.free_points(sel.coords, sel.radii, 1.4, 100,
                                 dtype=torch.bfloat16)
    assert f64.shape == bf16.shape == (317,)
    assert (f64 != bf16).sum() > 50


def test_residue_sums():
    got = reference.residue_sums([1.0, 2.0, 4.0], np.array([0, 2, 2]), 4)
    assert got.tolist() == [1.0, 0.0, 6.0, 0.0]
