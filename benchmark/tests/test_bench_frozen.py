"""The frozen copies are pinned to fixed values, not to the program."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from benchmark import generate, protor, run, sphere, structures, work

from .conftest import manifest


def test_sphere_points_pinned():
    pts = sphere.sphere_points(100)
    assert pts.dtype == np.float32 and pts.shape == (100, 3)
    assert pts[1].tolist() == [-0.14673446118831635, -0.13442084193229675,
                               0.9800000190734863]
    digests = {p: hashlib.sha256(sphere.sphere_points(p).tobytes()).hexdigest()
               for p in (100, 960)}
    assert digests == {
        100: "89dd5314df68ab28378f2e58a4448ab7c9c864d5b9067ab21820baccbee1ecc6",
        960: "b3deee74a5339a3d341b3cdf56e9dfe284f97cd4ff634e81f8e88883850a7779",
    }


def test_protor_table_pinned():
    table = protor.PROTOR_RADII
    assert len(table) == 40 and sum(len(v) for v in table.values()) == 506
    digest = hashlib.sha256(json.dumps(table, sort_keys=True).encode())
    assert digest.hexdigest() == (
        "cc71e4935b80dbd1c1cf7069c795b4064473b50c7713e20427cff9ad2d96c7ab")
    assert table["ALA"]["CB"] == 1.88 and table["ASP"]["OD2"] == 1.46


def _sizes():
    cfg = run.resolve_paths(run.cell_spec("proteome.dir", manifest())["config"])
    return {os.path.basename(p).split(".")[0]: len(structures.read_atoms(p).name)
            for p in cfg["structure_paths"]}


def test_corpus_rule_pinned():
    sizes = _sizes()
    assert len(sizes) == 34 and sum(sizes.values()) == 82457
    plans = [generate.corpus_plan(sizes, 4400, 10_700_000, s) for s in (0, 7)]
    for plan in plans:
        assert len(plan) == 4416
        assert sum(sizes[n] for n in plan) == 10_703_163
        assert len(set(plan)) == 34
    assert plans[0][:3] == ["3w7y", "3uc7", "2drt"]
    # Every seed gets the same copies, in another order.
    assert sorted(plans[0]) == sorted(plans[1]) and plans[0] != plans[1]


def test_corpus_prefix_of_all_88_is_the_configured_34():
    """The rule over the 88 FreeSASA structures the configuration was cut
    from picks exactly the 34 the benchmark carries."""
    src = os.path.join(run.REPO, "tests", "data", "freesasa_pdbs")
    sizes = {f.split(".")[0]: len(structures.read_atoms(os.path.join(src, f)).name)
             for f in os.listdir(src) if f.endswith(".pdb.gz")}
    plan = generate.corpus_plan(sizes, 4400, 10_700_000, 0)
    assert set(plan) == set(_sizes())


def test_jitter_frames_pinned():
    base = np.array([[0, 0, 0], [1, 2, 3]], np.float32)
    f = generate.jitter_frames(base, 2, 0.3, 0)
    assert f.dtype == np.float32 and f.shape == (2, 2, 3)
    assert f[0, 0].tolist() == [0.03771906718611717, -0.03963145986199379,
                                0.1921267956495285]
    assert f[1, 1].tolist() == [0.620373547077179, 1.8130176067352295,
                                3.0123977661132812]


def test_dcd_layout(tmp_path):
    frames = generate.jitter_frames(np.zeros((3, 3), np.float32), 2, 1.0, 1)
    path = tmp_path / "t.dcd"
    n = generate.write_dcd(str(path), frames)
    data = path.read_bytes()
    assert n == len(data) == 92 + 92 + 12 + 2 * 3 * (8 + 12)
    assert data[4:8] == b"CORD"
    body = np.frombuffer(data[196:], "<f4").reshape(2, 3, 5)
    assert np.array_equal(body[:, :, 1:4], np.transpose(frames, (0, 2, 1)))
    assert np.frombuffer(data[196:200], "<i4")[0] == 12


def test_poses_are_rotations():
    rot, shift = generate.poses(16, 25.0, 3)
    for r in rot:
        assert np.allclose(r @ r.T, np.eye(3), atol=1e-12)
        assert np.isclose(np.linalg.det(r), 1.0)
    assert np.abs(shift).max() <= 25.0


def test_work_counts_pinned():
    x = np.array([[0, 0, 0], [3, 0, 0], [10, 0, 0]], np.float32)
    r = np.array([1.5, 1.5, 1.5], np.float32)
    # 3 < 2 x 2.9: atoms 0 and 1 in reach of each other, atom 2 of none.
    assert work.pairs_in_reach(x, r, 1.4) == 2
    frames = np.stack([x, x * 0.5])
    assert work.frame_pairs_in_reach(frames, r, 1.4).tolist() == [2, 6]
    instr, nbytes = work.sasa_work(2, 3, 100)
    assert instr == 2 * 100 * 4 and nbytes == 3 * 20 + 1200
    assert work.least_seconds(33.5e12, 1.0) == 1.0
    assert work.least_seconds(1.0, 3.35e12) == 1.0
