"""The port's CUDA kernels against their plain-torch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import pathlib

import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from rustsasa_tpu_torch.ops import _kernels, engine, neighbors
from rustsasa_tpu_torch.ops import fused_kernel as fk
from rustsasa_tpu_torch.scripts import (
    _study, kernel_experiments, r3_kernel_variants, r3_maxplus, r4_atombox,
    r4_microkernel, r4_saturation, r5_pair64, r5_qwire,
)

pytestmark = pytest.mark.gpu

RADII = np.array([1.4, 1.55, 1.6, 1.7, 1.8, 1.9, 2.0], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _structures(sizes, seed, spread=30.0):
    rng = np.random.default_rng(seed)
    return [
        ((rng.uniform(0, spread, (n, 3)) + 50.0).astype(np.float32),
         rng.choice(RADII, n), np.arange(n, dtype=np.int32))
        for n in sizes
    ]


# n_points 20/60/100/256/1000 exercise one and several point passes and
# per-thread point counts K of 6, 16, 13, 16 and 16.
@pytest.mark.parametrize("n_points", [20, 60, 100, 256, 1000])
def test_kernel_byte_equal_plain(cuda, n_points):
    structures = _structures([100, 700, 2600, 3700], seed=n_points)
    structures[0][0][1] = structures[0][0][0]  # coincident atoms
    wa, wb, pal, tp, tm, offsets = fk.pack_structures_q13(structures, 1.4)
    wire = fk.to_device((wa, wb, pal, tp, tm), cuda)
    planes, qvalid = fk.dequant_q13(*wire[:4])
    jlist = fk.build_jlist_banded(planes, qvalid, wire[4], w=32)
    sphere = engine._sphere_device(n_points, cuda)
    before = _kernels.launch_counts["fused_count"]
    got = fk.fused_counts(planes, jlist, sphere)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["fused_count"] == before + 1
    want = fk.fused_counts_reference(planes, jlist, sphere)
    real = torch.zeros(wa.shape[0], dtype=torch.bool, device=cuda)
    for pos, n, _inv in offsets:
        real[pos:pos + n] = True
    assert torch.equal(got[real], want[real])
    assert int(got[real].max()) <= n_points


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("n_points", [20, 60, 100, 256, 1000])
def test_kernel_byte_equal_plain_on_tangent_pairs(cuda, n_points, far):
    """Near-tangent pairs (a rounding from flipping a count under an
    exact reach test), and with far pairs at the edge of the distance
    skip and spread past it (small j-radii about its guard): the kernel
    and its kRows instantiation byte-equal to the plain version, and the
    rows each warp streamed equal to the plain model's, fewer than the
    admitted ones."""
    planes, jlist, real = (torch.from_numpy(a).to(cuda) for a in
                           _study.tangent_chunk(n_points, 400, n_points,
                                                far=far))
    sphere = engine._sphere_device(n_points, cuda)
    want = fk.fused_counts_reference(planes, jlist, sphere)
    assert torch.equal(fk.fused_counts(planes, jlist, sphere)[real],
                       want[real])
    before = _kernels.launch_counts["fused_count_rows"]
    got, rows = _kernels.fused_count(planes, jlist, sphere, rows=True)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["fused_count_rows"] == before + 1
    assert torch.equal(got[real], want[real])
    work = fk.reach_work(planes, jlist, sphere)
    assert work["far"] > 0 or not far
    passes, _k = _kernels.lane_passes(n_points)
    assert torch.equal(rows.long(), work["warp_rows"] * passes)
    admitted = (int(jlist[:, 0].sum()) * 128 * rows.shape[1]
                * passes)
    assert 0 < int(rows.sum()) < admitted


def test_fused_count_rows_checks_inputs(cuda):
    planes = torch.zeros((8, 256), device=cuda)
    jlist = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    sphere = torch.zeros((104, 4), device=cuda)
    # Bulk copies need 16-byte aligned planes.
    shifted = torch.zeros(8 * 256 + 1, device=cuda)[1:].view(8, 256)
    with pytest.raises(ValueError, match="16-byte"):
        _kernels.fused_count(shifted, jlist, sphere)
    with pytest.raises(ValueError, match="16-byte"):
        _kernels.fused_count(shifted, jlist, sphere, rows=True)
    counts, rows = _kernels.fused_count(planes, jlist, sphere, rows=True)
    assert rows.shape == (2, 64) and int(rows.sum()) == 0
    assert counts.shape == (256,)


def test_engine_cuda_equals_cpu(cuda):
    structures = _structures([90, 400, 1300], seed=5)
    structures.append(_structures([260], seed=6, spread=120.0)[0])  # q16
    eng = engine.BatchedSasaEngine(device=cuda)
    _kernels.reset_launch_counts()
    got = eng.compute(structures)
    assert _kernels.launch_counts["fused_count"] == eng.chunks_dispatched == 2
    want = engine.BatchedSasaEngine(device="cpu").compute(structures)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_kernel_wrapper_checks_inputs(cuda):
    planes = torch.zeros((8, 256), device=cuda)
    sphere = torch.zeros((104, 4), device=cuda)
    with pytest.raises(ValueError, match="jlist shape"):
        _kernels.fused_count(planes, torch.zeros((1, 128), dtype=torch.int32,
                                                 device=cuda), sphere)
    with pytest.raises(TypeError):
        _kernels.fused_count(planes, torch.zeros((2, 128), device=cuda),
                             sphere)


def test_fused_count_on_host_cull_jlist_byte_equal_plain(cuda):
    # Host j-lists: full 0xFFFF masks (negative as int32) and a full
    # 127-entry row over repeated tiles, on the f32 planes.
    structures = _structures([150, 420, 300, 2000], seed=7, spread=20.0)
    planes, jlist, offsets, failed = fk.pack_structures(structures, 1.4, 100)
    assert failed == []
    jlist = jlist.copy()
    t = jlist.shape[0]
    jlist[0, 0] = fk.JLIST_CAP
    jlist[0, 1:] = (np.uint32(0xFFFF) << np.uint32(16)) | (
        np.arange(fk.JLIST_CAP, dtype=np.uint32) % np.uint32(t)
    )
    planes_d, jlist_d = fk.to_device((planes, jlist), cuda)
    assert int(jlist_d[0, 1]) < 0
    sphere = engine._sphere_device(100, cuda)
    got = fk.fused_counts(planes_d, jlist_d, sphere)
    want = fk.fused_counts_reference(planes_d, jlist_d, sphere)
    # Real slots equal; a padding slot (gid 0) skips every j-row, so its
    # count is its 100 valid points, not the reference's, and its area 0.
    real = planes_d[4] > 0
    assert torch.equal(got[real], want[real])
    assert bool((got[~real] == 100).all())
    area = fk.fused_sasa(planes_d, jlist_d, sphere, n_points=100)
    area_cpu = fk.fused_sasa(*fk.to_device((planes, jlist), "cpu"),
                             engine._sphere_device(100, torch.device("cpu")),
                             n_points=100)
    assert torch.equal(area.cpu(), area_cpu)


def _records(n, k, seed):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.uniform(-6, 6, (n, k, 3)).astype(np.float32))
    limit = torch.from_numpy(rng.uniform(-8, 2, (n, k)).astype(np.float32))
    counts = torch.from_numpy(rng.integers(0, k + 1, n))
    limit[torch.arange(k)[None, :] >= counts[:, None]] = -1e30
    area = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    return v, limit, counts, area


# P = 104 and 128 padded points: one block of points; 129, 960, 5,000
# and 50,000: 2, 8, 40 and 391 blocks, each CTA adding its counts.
@pytest.mark.parametrize("n_points", [100, 128, 129, 960, 5000, 50_000])
def test_list_occlusion_byte_equal_plain(cuda, n_points):
    v, limit, counts, area = (t.to(cuda) for t in _records(700, 40, 3))
    sphere = engine._sphere_device(n_points, cuda)
    kmax = neighbors.tile_kmax(counts, 40)
    before = _kernels.launch_counts["list_occlusion"]
    got = neighbors.occlusion_sasa(v, limit, area, sphere, kmax)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["list_occlusion"] == before + 1
    planes = [t.T.contiguous() for t in (v[..., 0], v[..., 1], v[..., 2],
                                        limit)]
    want = neighbors.occlusion_sasa_reference(*planes, area, sphere, kmax)
    assert torch.equal(got, want)
    assert (got > 0).any() and (got < area * n_points).any()


# Tiles at bound 0, K and in between, n neither a multiple of 128 nor of
# 4 (occlusion_sasa pads the K-major copies to 304 atoms), at one and at
# several blocks of points.  The records past each tile's bound hold real
# limits, which would occlude if they were read.
@pytest.mark.parametrize("wire", ["q12", "atombox"])
def test_kernel_on_q12_planes_and_atombox_jlists_byte_equal_plain(cuda, wire):
    """Kernel 1 on inputs of the round-4/5 studies: planes dequantized
    from the q12 wire (banded j-lists), and atombox j-lists on q16
    planes."""
    structures = _structures([100, 700, 2600, 3700], seed=31)
    if wire == "q12":
        *q12, offsets = r5_qwire.pack_q12(structures, 1.4)
        wa, wb, pal, tp, tm = fk.to_device(q12, cuda)
        planes, qvalid = r5_qwire.dequant_q12(wa, wb, pal, tp)
        jlist = fk.build_jlist_banded(planes, qvalid, tm, w=32)
    else:
        planes4, tp, tm, offsets = fk.pack_structures_q16(structures, 1.4)
        p4, tp, tm = fk.to_device((planes4, tp, tm), cuda)
        jlist, planes = r4_atombox.build_only(p4, tp, tm, w=32,
                                              fine="atombox")
        assert torch.equal(
            jlist, r4_atombox.build_only(p4, tp, tm, w=32, fine="sub32")[0])
    sphere = engine._sphere_device(100, cuda)
    before = _kernels.launch_counts["fused_count"]
    got = fk.fused_counts(planes, jlist, sphere)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["fused_count"] == before + 1
    want = fk.fused_counts_reference(planes, jlist, sphere)
    real = _study.real_slots(offsets, planes.shape[1], cuda)
    assert torch.equal(got[real], want[real])
    assert bool(((got[real] > 0) & (got[real] < 100)).any())


@pytest.mark.parametrize("n_points", [100, 300])
def test_list_occlusion_tile_bounds_byte_equal_plain(cuda, n_points):
    n, k = 301, 24
    rng = np.random.default_rng(12)
    v = torch.from_numpy(rng.uniform(-6, 6, (n, k, 3)).astype(np.float32))
    limit = torch.from_numpy(rng.uniform(-8, 2, (n, k)).astype(np.float32))
    area = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    v, limit, area = v.to(cuda), limit.to(cuda), area.to(cuda)
    sphere = engine._sphere_device(n_points, cuda)
    for bounds in ([0, k, 7], [k, 0, 1], [5, 9, k]):
        kmax = torch.tensor(bounds, dtype=torch.int32, device=cuda)
        got = _launched("list_occlusion", lambda: neighbors.occlusion_sasa(
            v, limit, area, sphere, kmax))
        planes = [t.T.contiguous() for t in (v[..., 0], v[..., 1],
                                            v[..., 2], limit)]
        want = neighbors.occlusion_sasa_reference(*planes, area, sphere,
                                                  kmax)
        assert torch.equal(got, want), bounds
        for t, bound in enumerate(bounds):
            if bound == 0:  # nothing occludes: every point counts
                rows = slice(128 * t, min(n, 128 * t + 128))
                assert torch.equal(got[rows], area[rows] * float(n_points))
        assert (got < area * n_points).any()


def test_list_path_engine_cuda_equals_cpu(cuda):
    structures = _structures([5, 90, 400], seed=8)
    structures.append((np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                       None))
    params = engine.SasaParams(n_points=2500)
    eng = engine.BatchedSasaEngine(params, device=cuda)
    assert eng.backend == "list"
    _kernels.reset_launch_counts()
    got = eng.compute(structures)
    assert (_kernels.launch_counts["list_occlusion"]
            == _kernels.launch_counts["neighbor_cells"]
            == _kernels.launch_counts["cell_keys"]
            == eng.routes.counts["list"])
    assert _kernels.launch_counts["fused_count"] == 0
    want = engine.BatchedSasaEngine(params, device="cpu").compute(structures)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_host_cull_engine_cuda_equals_cpu(cuda):
    small = _structures([100], seed=9)[0]
    shared = _structures([300], seed=10)[0]
    gids = shared[2].copy()
    gids[-1] = gids[0]
    big = _structures([16_600], seed=11, spread=110.0)[0]  # 130 tiles
    structures = [small, (shared[0], shared[1], gids), big]
    eng = engine.BatchedSasaEngine(device=cuda)
    got = eng.compute([small, big])
    assert eng.routes.counts["host_q16"] == 1
    got += eng.compute([(shared[0], shared[1], gids)])
    assert eng.routes.counts["f32"] == 1
    want = engine.BatchedSasaEngine(device="cpu").compute(
        [small, big]) + engine.BatchedSasaEngine(device="cpu").compute(
        [(shared[0], shared[1], gids)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got) == len(structures)


def test_list_occlusion_wrapper_checks_inputs(cuda):
    v = torch.zeros((8, 256), device=cuda)
    area = torch.zeros(256, device=cuda)
    sphere = torch.zeros((104, 4), device=cuda)
    kmax = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tile_kmax shape"):
        _kernels.list_occlusion(v, v, v, v, area, sphere, kmax[:1])
    with pytest.raises(TypeError):
        _kernels.list_occlusion(v, v, v, v, area, sphere, kmax.float())
    with pytest.raises(ValueError, match="area shape"):
        _kernels.list_occlusion(v, v, v, v, area[:128], sphere, kmax)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.list_occlusion(v.T, v, v, v, area, sphere, kmax)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.list_occlusion(*(t.cpu() for t in (v, v, v, v, area,
                                                     sphere, kmax)))
    w = v[:, :254].contiguous()
    with pytest.raises(ValueError, match="multiple of 4"):
        _kernels.list_occlusion(w, w, w, w, area[:254], sphere, kmax)


def _launched(name, fn):
    """fn()'s output, checking that it launched kernel `name` once."""
    before = _kernels.launch_counts[name]
    out = fn()
    torch.cuda.synchronize()
    assert _kernels.launch_counts[name] == before + 1
    return out


# P = 104 (2 passes of K = 13) and 960 (15 passes of K = 16).
@pytest.mark.parametrize("n_points", [100, 960])
def test_pair64_and_nibble_byte_equal_plain(cuda, n_points):
    structures = _structures([100, 700, 2600, 3700], seed=20 + n_points)
    planes4, tp, tm, offsets = fk.pack_structures_q16(structures, 1.4)
    planes4, tp, tm = fk.to_device((planes4, tp, tm), cuda)
    planes, qvalid = fk.dequant_q16(planes4, tp)
    sphere = engine._sphere_device(n_points, cuda)
    prod = fk.fused_counts(
        planes, fk.build_jlist_banded(planes, qvalid, tm, w=32), sphere
    )
    jlist_a, jmask_b = r5_pair64.build_jlist_banded_2h(planes, qvalid, tm,
                                                       w=32)
    jl, w1, w2 = r5_pair64.build_jlist_nibble(planes, qvalid, tm, w=32)
    assert (jlist_a[:, 1:] < 0).any() and (w1 < 0).any()  # bit 31 set
    real = torch.zeros(planes.shape[1], dtype=torch.bool, device=cuda)
    for pos, n, _inv in offsets:
        real[pos:pos + n] = True
    for name, kernel, plain in (
        ("pair64_count",
         lambda: r5_pair64.pair64_counts(planes, jlist_a, jmask_b, sphere),
         lambda: r5_pair64.pair64_counts_reference(planes, jlist_a, jmask_b,
                                                   sphere)),
        ("nibble_count",
         lambda: r5_pair64.nibble_counts(planes, jl, w1, w2, sphere),
         lambda: r5_pair64.nibble_counts_reference(planes, jl, w1, w2,
                                                   sphere)),
    ):
        got = _launched(name, kernel)
        assert torch.equal(got, plain()), name
        assert torch.equal(got[real], prod[real]), name


@pytest.mark.parametrize("n_points", [100, 960])
def test_saturation_byte_equal_plain(cuda, n_points):
    structures = _structures([150, 420, 300, 2000], seed=30, spread=20.0)
    planes5, jlist, _offsets, failed = fk.pack_structures(structures, 1.4, 100)
    assert failed == []
    sphere = engine._sphere_device(n_points, cuda)
    passes, _k = _kernels.lane_passes(sphere.shape[0])
    for wire in ((planes5, jlist), r4_saturation.buried_block_wire()):
        planes, jl = fk.to_device(wire, cuda)
        prod = fk.fused_counts(planes, jl, sphere)
        # fused_count's counts at padding slots are not the reference's.
        real = planes[4] > 0
        for check_every in (1, 2, 4):
            got, streamed = _launched(
                "saturation_count",
                lambda: r4_saturation.saturation_counts(
                    planes, jl, sphere, check_every=check_every),
            )
            want, want_streamed = r4_saturation.saturation_counts_reference(
                planes, jl, sphere, check_every=check_every
            )
            assert torch.equal(got, want)
            assert torch.equal(got[real], prod[real])
            assert torch.equal(streamed, want_streamed)
            assert bool((streamed <= passes * jl[:, 0]).all())
    # The lattice's buried tile stops early in every pass; the shell's do not.
    assert int(streamed[0]) < passes * int(jl[0, 0])
    assert torch.equal(streamed[1:], passes * jl[1:, 0])


def _saturation_equal_plain(planes, jl, sphere, checks=(1, 2, 4)):
    """The saturation kernel's counts and entries streamed byte-equal to
    the plain version's at every check interval -> the last streamed."""
    for check_every in checks:
        got, streamed = _launched(
            "saturation_count",
            lambda: r4_saturation.saturation_counts(
                planes, jl, sphere, check_every=check_every))
        want, want_streamed = r4_saturation.saturation_counts_reference(
            planes, jl, sphere, check_every=check_every)
        assert torch.equal(got, want), check_every
        assert torch.equal(streamed, want_streamed), check_every
    return streamed


def test_saturation_edge_chunks(cuda):
    """A one-tile chunk (one cluster of four CTAs), tiles with no entry and
    with dead entries only, and a pass with no valid point (saturated
    before its first entry, so it stops at its first check)."""
    sphere = engine._sphere_device(100, cuda)
    planes5, jlist, _offsets, failed = fk.pack_structures(
        _structures([90], seed=31, spread=12.0), 1.4, 100)
    assert failed == [] and jlist.shape[0] == 1
    planes, jl = fk.to_device((planes5, jlist), cuda)
    _saturation_equal_plain(planes, jl, sphere)
    planes, jl = fk.to_device(r4_saturation.buried_block_wire(), cuda)
    jl[1, 0] = 0  # no entry
    jl[2, 1:] &= 0xFFFF  # every entry dead (no group bit)
    streamed = _saturation_equal_plain(planes, jl, sphere)
    assert streamed[1:].tolist() == [0, 7]
    planes, jl = fk.to_device(r4_saturation.buried_block_wire(), cuda)
    sphere = engine._sphere_device(960, cuda).clone()
    passes, k = _kernels.lane_passes(sphere.shape[0])
    sphere[16 * k:2 * 16 * k, 3] = 0.0  # pass 1: pad points only
    for check_every, streamed in zip((1, 2, 4), (
            [3 * 3 + 1, 3 * 7 + 1, 3 * 7 + 1], [3 * 4 + 2, 3 * 7 + 2, 3 * 7 + 2],
            [3 * 4 + 4, 3 * 7 + 4, 3 * 7 + 4])):
        got = _saturation_equal_plain(planes, jl, sphere, (check_every,))
        assert got.tolist() == streamed, check_every


def test_count_study_wrappers_check_inputs(cuda):
    planes = torch.zeros((8, 256), device=cuda)
    sphere = torch.zeros((104, 4), device=cuda)
    jl = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="jmask_b shape"):
        _kernels.pair64_count(planes, jl, jl[:1], sphere)
    with pytest.raises(TypeError):
        _kernels.nibble_count(planes, jl, jl.float(), jl, sphere)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.nibble_count(planes, jl, jl, jl.T.contiguous().T, sphere)
    with pytest.raises(ValueError, match="check_every"):
        _kernels.saturation_count(planes, jl, sphere, 0)
    with pytest.raises(ValueError, match="sphere shape"):
        _kernels.saturation_count(planes, jl, torch.zeros((4000, 4),
                                                          device=cuda), 1)
    with pytest.raises(ValueError, match="planes shape"):
        _kernels.pair64_count(planes[:, :200].contiguous(), jl, jl, sphere)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.saturation_count(planes.cpu(), jl.cpu(), sphere.cpu(), 1)
    # Kernel 1's layout copies plane rows in bulk: 16-byte aligned.
    shifted = torch.zeros(8 * 256 + 1, device=cuda)[1:].view(8, 256)
    with pytest.raises(ValueError, match="16-byte"):
        _kernels.saturation_count(shifted, jl, sphere, 1)
    with pytest.raises(ValueError, match="16-byte"):
        _kernels.micro_count(shifted, jl, sphere, "prod")
    with pytest.raises(ValueError, match="16-byte"):
        _kernels.reach_count(shifted, jl, sphere, "base")
    with pytest.raises(ValueError, match="16-byte"):
        _kernels.nibble_count(shifted, jl, jl, jl, sphere)
    with pytest.raises(ValueError, match="16-byte"):
        _kernels.pair64_count(shifted, jl, jl, sphere)


@pytest.fixture(scope="module")
def corpus_triples():
    """The repository's FreeSASA structures of <= 32 tiles filling 65,536
    slots, selected as process_directory selects them."""
    return _study.load_corpus(slots=65_536, max_tiles=32)


def _study_wires(cuda, triples):
    """(planes, jlist, real) of a host-cull f32 corpus chunk and of the
    buried lattice block."""
    planes, jl, real, _atoms, _tiles, failed = _study.host_cull_chunk(
        triples, cuda, 65_536)
    assert failed == 0
    lattice, lattice_jl = fk.to_device(r4_saturation.buried_block_wire(), cuda)
    return ((planes, jl, real), (lattice, lattice_jl, lattice[4] > 0.0))


@pytest.mark.parametrize("n_points", [100, 960])
def test_micro_count_byte_equal_plain(cuda, corpus_triples, n_points):
    sphere = engine._sphere_device(n_points, cuda)
    for planes, jl, real in _study_wires(cuda, corpus_triples):
        prod = fk.fused_counts(planes, jl, sphere)
        for variant in r4_microkernel.VARIANTS:
            got = _launched("micro_count", lambda: r4_microkernel.micro_counts(
                planes, jl, sphere, variant=variant))
            want = r4_microkernel.micro_counts_reference(
                planes, jl, sphere, variant=variant)
            assert torch.equal(got, want), variant
            assert torch.equal(got[real], prod[real]), variant


@pytest.mark.parametrize("n_points", [100, 960])
def test_reach_count_byte_equal_plain(cuda, corpus_triples, n_points):
    sphere = engine._sphere_device(n_points, cuda)
    for planes, jl, real in _study_wires(cuda, corpus_triples):
        prod = fk.fused_counts(planes, jl, sphere)
        for variant in r3_kernel_variants.VARIANTS:
            got, executed = _launched(
                "reach_count", lambda: r3_kernel_variants.reach_counts(
                    planes, jl, sphere, variant=variant))
            want, want_executed = r3_kernel_variants.reach_counts_reference(
                planes, jl, sphere, variant=variant)
            assert torch.equal(got, want), variant
            assert torch.equal(executed, want_executed), variant
            if variant in r3_kernel_variants.F32_VARIANTS:
                assert torch.equal(got[real], prod[real]), variant


def _as_i32(values):
    """i64 tensor of 32-bit words -> i32, bit 31 wrapping negative."""
    return (values - ((values >> 31) & 1) * (1 << 32)).to(torch.int32)


def _past_and_full(jl, t, words=None):
    """Edge j-lists in place: tile 0 with no entry, tile 1 with three more
    entries on j-tiles at or past the chunk's end (t, t + 7, 0xFFFF), tile
    2 with 127 entries of all 16 groups over repeated j-tiles.  Entries
    carry masks ((0xFFFF << 16) | j: negative as int32), or with `words`
    (the nibble lists' w1, w2) a group count and nibbles.  Returns the
    positions of the past-the-end entries of tile 1."""
    dev = jl.device
    jl[0, 0] = 0
    n = int(jl[1, 0])
    assert n + 3 <= fk.JLIST_CAP
    past = [1 + n, 2 + n, 3 + n]
    high = (3 << 16) if words else (0xFFFF << 16)
    jl[1, past] = _as_i32(high | torch.tensor([t, t + 7, 0xFFFF],
                                              device=dev))
    jl[1, 0] = n + 3
    jl[2, 0] = fk.JLIST_CAP
    tiles = torch.arange(fk.JLIST_CAP, device=dev) % t
    if words:
        w1, w2 = words
        w1[1, past], w2[1, past] = 0x210, 0
        jl[2, 1:] = _as_i32((16 << 16) | tiles)
        w1[2, 1:] = _as_i32(torch.full_like(tiles, 0x76543210))
        w2[2, 1:] = _as_i32(torch.full_like(tiles, 0xFEDCBA98))
    else:
        jl[2, 1:] = _as_i32((0xFFFF << 16) | tiles)
    return past


def _reach_edge_chunks(cuda):
    """(planes, jlist) pairs on the card: a one-tile chunk and a 5-tile
    host-cull chunk with _past_and_full's edges."""
    out = []
    for sizes, seed in (([90], 41), ([150, 330], 42)):
        planes5, jlist, _offsets, failed = fk.pack_structures(
            _structures(sizes, seed=seed, spread=14.0), 1.4, 100)
        assert failed == []
        out.append(fk.to_device((planes5, jlist), cuda))
    planes, jl = out[1]
    assert out[0][1].shape[0] == 1 and jl.shape[0] == 5
    _past_and_full(jl, jl.shape[0])
    assert int(jl[2, 1:].min()) < 0
    return out


def _nibble_edge_chunks(cuda):
    """((planes, (jl, w1, w2)), plain lists) pairs on the card: a one-tile
    banded q16 chunk's nibble lists, and a 6-tile chunk's with
    _past_and_full's edges (all 16 groups: w2 negative); the plain
    version takes the entries past the chunk's end dead (gcount 0), as
    the kernel does."""
    out = []
    for sizes, seed in (([90], 43), ([100, 520], 44)):
        planes4, tp, tm, _offsets = fk.pack_structures_q16(
            _structures(sizes, seed=seed, spread=14.0), 1.4)
        planes4, tp, tm = fk.to_device((planes4, tp, tm), cuda)
        planes, qvalid = fk.dequant_q16(planes4, tp)
        lists = r5_pair64.build_jlist_nibble(planes, qvalid, tm, w=16)
        out.append([planes, lists, lists])
    planes, (jl, w1, w2), _ = out[1]
    assert out[0][1][0].shape[0] == 1 and jl.shape[0] == 6
    jl, w1, w2 = jl.clone(), w1.clone(), w2.clone()
    past = _past_and_full(jl, jl.shape[0], (w1, w2))
    assert (w2[2, 1:] < 0).all()
    dead = jl.clone()
    dead[1, past] &= 0xFFFF
    out[1][1:] = (jl, w1, w2), (dead, w1, w2)
    return out


# P = 1, 65, 100, 129, 960 and 2048 pad to 8, 72, 104, 136, 960 and
# 2048 points: one pass of K = 1, 5, 7 and 9 points a lane, then 4 passes
# of 15 and 8 of 16 (lane_passes), across the count_tile split that
# `executed` counts in.
@pytest.mark.parametrize("n_points", [1, 65, 100, 129, 960, 2048])
def test_reach_count_edge_chunks(cuda, n_points):
    sphere = engine._sphere_device(n_points, cuda)
    for planes, jl in _reach_edge_chunks(cuda):
        for variant in r3_kernel_variants.VARIANTS:
            got, executed = _launched(
                "reach_count", lambda: r3_kernel_variants.reach_counts(
                    planes, jl, sphere, variant=variant))
            want, want_executed = r3_kernel_variants.reach_counts_reference(
                planes, jl, sphere, variant=variant)
            assert torch.equal(got, want), variant
            assert torch.equal(executed, want_executed), variant
    # The tile with no entry executes nothing.
    assert int(executed[0]) == 0


def _rule_words_plain(planes, jl, variant):
    """{(tile, j-list position): the rule's four 32-row words} of every
    live entry, in plain torch: row jj of the j-tile is in reach when v2
    - (r_i + r_j)^2 < 0 for some of the tile's 128 atoms; base-like rules
    take 8-row groups with a row in reach, nogroupcond every row."""
    t = jl.shape[0]
    out = {}
    for tile in range(t):
        ci = planes[0:3, tile * 128:(tile + 1) * 128]  # [3, A]
        ri = planes[3, tile * 128:(tile + 1) * 128]
        for e in range(min(max(int(jl[tile, 0]), 0), fk.JLIST_CAP)):
            jt = int(jl[tile, 1 + e]) & 0xFFFF
            if jt >= t:
                continue
            cj = planes[0:3, jt * 128:(jt + 1) * 128]
            rj = planes[3, jt * 128:(jt + 1) * 128]
            v = ci[:, None, :] - cj[:, :, None]  # [3, J, A]
            v2 = (v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]
            reach = ri[None, :] + rj[:, None]
            hit = ((v2 - reach * reach) < 0.0).any(dim=1)  # [J]
            if variant == "nogroupcond":
                hit = torch.ones_like(hit)
            elif variant not in ("jskip", "group4"):
                hit = hit.reshape(16, 8).any(dim=1).repeat_interleave(8)
            bits = hit.reshape(4, 32).to(torch.int64) << torch.arange(
                32, device=hit.device)
            out[tile, e] = _as_i32(bits.sum(dim=1)).tolist()
    return out


@pytest.mark.parametrize("variant", ["base", "nogroupcond", "jskip"])
def test_reach_rule_words_equal_plain(cuda, variant):
    sphere = engine._sphere_device(100, cuda)
    for planes, jl in _reach_edge_chunks(cuda):
        rule, executed = _launched("reach_rule", lambda: _kernels.reach_rule(
            planes, jl, sphere, variant))
        want = _rule_words_plain(planes, jl, variant)
        assert {key: rule[key].tolist() for key in want} == want
        _counts, full_executed = r3_kernel_variants.reach_counts(
            planes, jl, sphere, variant=variant)
        assert torch.equal(executed, full_executed)


@pytest.mark.parametrize("n_points", [1, 65, 100, 129, 960, 2048])
def test_nibble_count_edge_chunks(cuda, n_points):
    sphere = engine._sphere_device(n_points, cuda)
    for planes, lists, plain_lists in _nibble_edge_chunks(cuda):
        got = _launched("nibble_count", lambda: r5_pair64.nibble_counts(
            planes, *lists, sphere))
        want = r5_pair64.nibble_counts_reference(planes, *plain_lists, sphere)
        assert torch.equal(got, want)
        prod = fk.fused_counts_reference(
            planes, r5_pair64._nibble_masks(*plain_lists), sphere)
        assert torch.equal(got, prod)


def _pair64_edge_chunks(cuda):
    """((planes, (jlist_a, jmask_b)), plain lists) pairs on the card: a
    one-tile banded q16 chunk's per-half lists, a 6-tile chunk's with
    _past_and_full's edges (mask B of tile 2's 127 entries cycling
    through all groups, none, one and mask A's complement; the past
    entries all groups), and near-tangent pairs at the reach slack's edge
    with every entry's masks split over the halves at random (some
    entries one half's only, some neither's); the plain version takes
    the entries past the chunk's end dead (both masks 0), as the kernel
    does."""
    out = []
    for sizes, seed in (([90], 45), ([100, 520], 46)):
        planes4, tp, tm, _offsets = fk.pack_structures_q16(
            _structures(sizes, seed=seed, spread=14.0), 1.4)
        planes4, tp, tm = fk.to_device((planes4, tp, tm), cuda)
        planes, qvalid = fk.dequant_q16(planes4, tp)
        lists = r5_pair64.build_jlist_banded_2h(planes, qvalid, tm, w=16)
        out.append([planes, lists, lists])
    planes, (jl, jm), _ = out[1]
    assert out[0][1][0].shape[0] == 1 and jl.shape[0] == 6
    jl, jm = jl.clone(), jm.clone()
    past = _past_and_full(jl, jl.shape[0])
    jm[1, 0] = jl[1, 0]
    jm[1, past] = 0xFFFF
    jm[2, 0] = jl[2, 0]
    cycle = torch.tensor([0xFFFF, 0, 0x8001, 0x0F0F], device=cuda)
    jm[2, 1:] = cycle[torch.arange(fk.JLIST_CAP, device=cuda) % 4]
    dead_a, dead_b = jl.clone(), jm.clone()
    dead_a[1, past] &= 0xFFFF
    dead_b[1, past] = 0
    out[1][1:] = (jl, jm), (dead_a, dead_b)
    planes, jlist, _real = (torch.from_numpy(a).to(cuda) for a in
                            _study.tangent_chunk(100, 400, 47, far=True))
    rng = torch.Generator(device="cpu").manual_seed(47)
    ent = jlist.long() & 0xFFFFFFFF
    masks = torch.randint(0, 1 << 16, jlist.shape + (2,), generator=rng)
    masks[..., 0, :] = 0
    masks[:, 1:4] = torch.tensor([[0xFFFF, 0], [0, 0xFFFF], [0, 0]])
    masks = masks.to(cuda)
    jlist_a = torch.where(torch.arange(128, device=cuda) > 0,
                          (masks[..., 0] << 16) | (ent & 0xFFFF), ent)
    jmask_b = torch.where(torch.arange(128, device=cuda) > 0, masks[..., 1],
                          ent)
    lists = (_as_i32(jlist_a), _as_i32(jmask_b))
    out.append([planes, lists, lists])
    return out


@pytest.mark.parametrize("n_points", [1, 65, 100, 129, 960, 2048])
def test_pair64_count_edge_chunks(cuda, n_points):
    sphere = engine._sphere_device(n_points, cuda)
    for planes, lists, plain_lists in _pair64_edge_chunks(cuda):
        got = _launched("pair64_count", lambda: r5_pair64.pair64_counts(
            planes, *lists, sphere))
        want = r5_pair64.pair64_counts_reference(planes, *plain_lists, sphere)
        assert torch.equal(got, want)


# n_points 1, 64, 65, 100, 128, 129, 960 and 2048 pad to 8, 64, 72, 104,
# 128, 136, 960 and 2048 points: each pass and K boundary of the kernel's
# split (passes of 8 x K <= 16 points) and of the other count kernels'
# (4 x K <= 16).
@pytest.mark.parametrize("n_points", [1, 64, 65, 100, 128, 129, 960, 2048])
def test_maxplus_count_byte_equal_plain(cuda, corpus_triples, n_points):
    sphere = engine._sphere_device(n_points, cuda)
    planes, qvalid, tmeta, real, _atoms, _tiles = _study.banded_chunk(
        corpus_triples, cuda, 65_536)
    jl = fk.build_jlist_banded(planes, qvalid, tmeta, w=32)
    # Tile 0 with an empty j-list, tile 1 with 127 entries of all 16
    # groups over repeated j-tiles (0xFFFF masks: negative as int32).
    edge = jl.clone()
    edge[0, 0] = 0
    edge[1, 0] = fk.JLIST_CAP
    ents = (0xFFFF << 16) | (torch.arange(fk.JLIST_CAP, device=cuda)
                             % edge.shape[0])
    edge[1, 1:] = (ents - (1 << 32)).to(torch.int32)
    lattice, lattice_jl = fk.to_device(r4_saturation.buried_block_wire(), cuda)
    for planes, jl, real in ((planes, jl, real), (planes, edge, real),
                             (lattice, lattice_jl, lattice[4] > 0.0)):
        got = _launched("maxplus_count", lambda: r3_maxplus.maxplus_counts(
            planes, jl, sphere))
        assert torch.equal(got, r3_maxplus.maxplus_counts_reference(
            planes, jl, sphere))
        prod = fk.fused_counts(planes, jl, sphere)
        flips = (got.to(torch.int64) - prod.to(torch.int64)).abs()[real]
        assert int(flips.max()) <= r3_maxplus.MAX_FLIPS


def test_count_study_ii_wrappers_check_inputs(cuda):
    planes = torch.zeros((8, 256), device=cuda)
    sphere = torch.zeros((104, 4), device=cuda)
    jl = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="unknown variant"):
        _kernels.micro_count(planes, jl, sphere, "g32")
    with pytest.raises(ValueError, match="unknown variant"):
        _kernels.reach_count(planes, jl, sphere, "fp8")
    with pytest.raises(ValueError, match="jlist shape"):
        _kernels.maxplus_count(planes, jl[:1], sphere)
    with pytest.raises(TypeError):
        _kernels.reach_count(planes, jl.float(), sphere, "base")
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.maxplus_count(planes.cpu(), jl.cpu(), sphere.cpu())


@pytest.mark.parametrize("source", list(_kernels.KE_VARIANTS))
@pytest.mark.parametrize("jdata", ["ones", "random"])
def test_kernel_experiments_equal_plain(cuda, source, jdata):
    """Every variant of each kernel-experiment source against its plain
    version: sums and executed groups byte-equal (DEFAULT's sums within
    kernel_experiments.default_bound)."""
    ke = kernel_experiments
    sphere, planes, jd = ke.synthetic_inputs(6, 256, cuda, jdata)
    for variant in _kernels.KE_VARIANTS[source]:
        assert ke.source(variant) == source
        got = _launched(source, lambda v=variant: ke.experiment(
            v, sphere, planes, jd))
        want = ke.experiment_reference(planes, variant, sphere, jd)
        err, ok = ke.agreement(variant, sphere, planes, jd, got, want)
        assert ok, (variant, err)
        assert bool(torch.isfinite(got[0]).all())
        if jdata == "random" and ke.VARIANTS[variant][1].get("skip"):
            groups = 6 * ke.jrows(variant, 256) // ke.GROUP
            assert 0 < int(got[1].sum()) < groups


# NJ = 8 (one group) and 2,048 (the most resident j-rows).
@pytest.mark.parametrize("nj", [8, 2048])
@pytest.mark.parametrize("jdata", ["ones", "random"])
def test_mxu_dots_def_equal_plain(cuda, nj, jdata):
    """The DEFAULT matrix-unit dots (wgmma) against their plain version:
    sums within kernel_experiments.default_bound, executed groups
    byte-equal."""
    ke = kernel_experiments
    sphere, planes, jd = ke.synthetic_inputs(6, nj, cuda, jdata)
    got = _launched("ke_mxu", lambda: ke.experiment(
        "mxu_dots_def", sphere, planes, jd))
    want = ke.experiment_reference(planes, "mxu_dots_def", sphere, jd)
    err, ok = ke.agreement("mxu_dots_def", sphere, planes, jd, got, want)
    assert ok, err
    assert bool(torch.isfinite(got[0]).all())
    assert torch.equal(got[1], torch.full_like(got[1], nj // ke.GROUP))


# nobig and noscalar run kernels of their own (a fold of the limits, one
# constant row): byte-equal to the plain versions at one group, the
# script's and the most j-rows, on 5 tiles (nobig's last CTA holds one),
# on the ones, random and far j-data, and on random j-data whose rows
# all share tile 0's gid ("one_gid": every limit of that tile masked).
@pytest.mark.parametrize("nj", [8, 1408, 2048])
@pytest.mark.parametrize("jdata", ["ones", "random", "far", "one_gid"])
def test_nobig_and_noscalar_byte_equal_plain(cuda, nj, jdata):
    ke = kernel_experiments
    sphere, planes, jd = ke.synthetic_inputs(
        5, nj, cuda, "random" if jdata == "one_gid" else jdata)
    if jdata == "one_gid":
        jd[:, 4] = 5.0
        planes[4, :ke.A] = 5.0
    for variant in ("nobig", "noscalar"):
        got = _launched("ke_stream", lambda v=variant: ke.experiment(
            v, sphere, planes, jd))
        want = ke.experiment_reference(planes, variant, sphere, jd)
        assert torch.equal(got[0], want[0]), variant
        assert torch.equal(got[1], want[1]), variant
        assert bool(torch.isfinite(got[0]).all())
        if variant == "nobig" and jdata == "one_gid":
            # Every limit of tile 0 is masked: 128 x -1e30, in order.
            assert bool((got[0][:ke.A] < -1e31).all())


# The far j-data (the first and last group of each j-tile and the last
# i-tile out of reach) at the fewest, the script's and the most j-rows of
# each source.
@pytest.mark.parametrize("source, nj", [
    ("ke_maxplus", 128), ("ke_maxplus", 1408), ("ke_maxplus", 2048),
    ("ke_bf16", 8), ("ke_bf16", 256), ("ke_bf16", 2048)])
def test_kernel_experiments_on_far_groups(cuda, source, nj):
    """ke_maxplus.cu and ke_bf16.cu against their plain versions where the
    reach test leaves whole groups and a whole tile out: sums byte-equal
    (DEFAULT within default_bound), executed byte-equal, and 0 for the
    tile that reaches no group."""
    ke = kernel_experiments
    sphere, planes, jd = ke.synthetic_inputs(6, nj, cuda, "far")
    for variant in _kernels.KE_VARIANTS[source]:
        got = _launched(source, lambda v=variant: ke.experiment(
            v, sphere, planes, jd))
        want = ke.experiment_reference(planes, variant, sphere, jd)
        err, ok = ke.agreement(variant, sphere, planes, jd, got, want)
        assert ok, (variant, err)
        assert bool(torch.isfinite(got[0]).all())
        groups = ke.jrows(variant, nj) // ke.GROUP
        if ke.VARIANTS[variant][1].get("skip"):
            assert int(got[1][-1]) == 0
            assert int(got[1].max()) <= groups - min(2, groups)
        else:
            assert torch.equal(got[1], torch.full_like(got[1], groups))


def test_kernel_experiment_wrapper_checks_inputs(cuda):
    sphere, planes, jd = kernel_experiments.synthetic_inputs(1, 128, cuda)
    with pytest.raises(ValueError, match="unknown variant"):
        _kernels.kernel_experiment("ke_stream", "g16", sphere, planes, jd)
    with pytest.raises(ValueError, match="jdata shape"):
        _kernels.kernel_experiment("ke_maxplus", "mp_tile_hi", sphere,
                                   planes, jd[:64])
    with pytest.raises(ValueError, match="sphere shape"):
        _kernels.kernel_experiment("ke_mxu", "mxu_dots_hi", sphere[:100],
                                   planes, jd)
    with pytest.raises(TypeError):
        _kernels.kernel_experiment("ke_bf16", "g8_bf16", sphere, planes,
                                   jd.double())
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.kernel_experiment("ke_stream", "full", sphere.cpu(),
                                   planes.cpu(), jd.cpu())


def test_process_directory_cuda_equals_cpu(cuda, tmp_path):
    """The port's own host code (parser, selection, emit) around the CUDA
    engine: three files give the CPU run's JSON, byte for byte."""
    from rustsasa_tpu_torch import (
        BatchedSasaEngine, Level, SASAOptions, SasaParams, process_directory,
    )

    src = tmp_path / "in"
    src.mkdir()
    data = _study.TEST_STRUCTURES
    for name in ("2drt.pdb.gz", "2gpi.pdb.gz", "3uc7.pdb.gz"):
        (src / name).symlink_to(f"{data}/{name}")
    outs = {}
    for dev in (cuda, "cpu"):
        out = tmp_path / f"out_{dev}"
        rep = process_directory(
            str(src), str(out), SASAOptions(level=Level.RESIDUE), "json",
            progress=False, engine=BatchedSasaEngine(SasaParams(), device=dev))
        assert rep.n_ok == rep.n_files == 3 and not rep.errors
        outs[str(dev)] = {f.name: f.read_bytes() for f in sorted(out.iterdir())}
    assert outs[str(cuda)] == outs["cpu"] and len(outs["cpu"]) == 3


DATA = pathlib.Path(__file__).resolve().parent / "data"


def test_cli_cuda_equals_cpu(cuda, tmp_path):
    """The CLI's single-file route on example.cif at residue level: every
    value of the cuda run within 1e-3 of the cpu run's (the count kernel
    is byte-equal to its plain version, so the files are expected equal)."""
    import json

    from rustsasa_tpu_torch.cli import main

    docs = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.json"
        _kernels.reset_launch_counts()
        assert main([str(DATA / "pdbs" / "example.cif"), str(out),
                     "--output-depth", "residue", "--device", dev]) == 0
        assert _kernels.launch_counts["fused_count"] == (dev == "cuda")
        docs[dev] = json.loads(out.read_text())["Residue"]
    assert len(docs["cuda"]) == len(docs["cpu"]) > 100
    for got, want in zip(docs["cuda"], docs["cpu"]):
        assert got["value"] == pytest.approx(want["value"], abs=1e-3)
        assert {k: v for k, v in got.items() if k != "value"} == {
            k: v for k, v in want.items() if k != "value"}


def test_trajectory_on_card_equals_calculate_sasa_internal(cuda, tmp_path):
    from rustsasa_tpu_torch import SASAOptions, Level, calculate_sasa_internal
    from rustsasa_tpu_torch.io.read import read_structure
    from rustsasa_tpu_torch.levels import _residue_sums
    from rustsasa_tpu_torch.trajectory import compute_trajectory_sasa, write_dcd

    top = str(DATA / "pdbs" / "example.cif")
    structure = read_structure(top)
    rng = np.random.default_rng(0)
    frames = structure.atoms.coords[None].astype(np.float32) + rng.normal(
        0.0, 0.3, (5, structure.n_atoms(), 3)).astype(np.float32)
    dcd = tmp_path / "t.dcd"
    write_dcd(str(dcd), frames)
    opts = SASAOptions(level=Level.RESIDUE)
    _kernels.reset_launch_counts()
    result = compute_trajectory_sasa(top, str(dcd), opts, block=2)
    assert _kernels.launch_counts["fused_count"] == 3
    sel = opts.build_selection(structure)
    for f in range(5):
        atom_sasa = calculate_sasa_internal(
            frames[f][sel.atom_indices], sel.radii, group_ids=sel.group_ids,
            device=cuda)
        assert result.totals[f] == np.float32(float(atom_sasa.sum()))
        np.testing.assert_array_equal(result.residue_values[f],
                                      _residue_sums(sel, atom_sasa))


def test_golden_and_sanity_on_card(cuda):
    """tests/test_golden.py's per-atom case and tests/test_sanity.py's
    overlapping spheres (50,000 points: the list path) on "cuda"."""
    import math

    from rustsasa_tpu_torch import (
        calculate_sasa_internal, get_vdw_radius, read_structure,
    )

    s = read_structure(str(DATA / "pdbs" / "example.cif"))
    t = s.atoms
    order = list(s.iter_hierarchy_atom_indices())
    radii = np.array([get_vdw_radius(t.element[i]) for i in order],
                     np.float32)
    sasa = calculate_sasa_internal(
        t.coords[order], radii, group_ids=t.serial[order], probe_radius=1.4,
        n_points=100, device=cuda)
    golden = np.load(DATA / "golden_example_atom_sasa.npy")
    np.testing.assert_allclose(sasa, golden, atol=25.0)
    assert float(np.abs(sasa - golden).mean()) < 1.5

    r, dist = 2.0 + 1.4, 4.0
    out = calculate_sasa_internal(
        np.array([[0, 0, 0], [dist, 0, 0]], np.float32),
        np.array([2.0, 2.0], np.float32), probe_radius=1.4,
        n_points=50_000, device=cuda)
    expected = 4.0 * math.pi * r * r - 2.0 * math.pi * r * (r - dist / 2.0)
    assert out == pytest.approx([expected, expected], rel=0.005)


def test_two_streams_equal_one(cuda, monkeypatch):
    """Chunks dealt round-robin to two streams on one card give the bytes
    one stream gives; every entry dispatches, and the entries' chunks
    are the count kernel's launches."""
    monkeypatch.setattr(engine, "CHUNK_SLOT_BUDGET", 1024)
    structures = _structures([900, 300, 700, 1000, 500, 260, 800], seed=11)
    one = engine.BatchedSasaEngine(device=cuda).compute(structures)
    eng = engine.BatchedSasaEngine(devices=[cuda, cuda])
    assert eng.ring.streams[0] != eng.ring.streams[1]
    # One entry runs on the caller's stream.
    assert engine.BatchedSasaEngine(device=cuda).ring.streams == [None]
    _kernels.reset_launch_counts()
    handles = [eng.enqueue(structures[i::2]) for i in range(2)]
    got = [h.collect() for h in handles]
    assert min(eng.routes.entries) >= 1
    assert (sum(eng.routes.entries) == eng.chunks_dispatched
            == _kernels.launch_counts["fused_count"])
    for i in range(2):
        for g, w in zip(got[i], one[i::2]):
            np.testing.assert_array_equal(g, w)


def test_sharded_list_step_equals_unsharded(cuda):
    """The sharded list step over two streams of one card is byte-equal
    to `_sasa_batched` on the whole batch, one list kernel a shard."""
    from rustsasa_tpu_torch import graft_entry
    from rustsasa_tpu_torch.parallel import mesh

    packed, gid, sphere = graft_entry._example_batch(b=8, n=256)
    step = mesh.make_sharded_sasa([cuda, cuda], k=64, n_points=100)
    _kernels.reset_launch_counts()
    sasa, total, max_count = step(packed, gid, sphere)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["list_occlusion"] == 2
    assert _kernels.launch_counts["neighbor_cells"] == 2
    assert _kernels.launch_counts["cell_keys"] == 2
    whole, whole_mc = neighbors._sasa_batched(
        *(torch.from_numpy(a).to(cuda) for a in (packed, gid, sphere)),
        k=64, n_points=100, probe=1.4)
    assert torch.equal(sasa, whole)
    assert float(total[0]) == float(whole.double().sum())
    assert int(max_count[0]) == int(whole_mc)
    graft_entry.dryrun_multichip([cuda, cuda])


def _bits(t):
    """A float tensor's words, for bit-equal comparisons."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("wire", ["q13", "q16"])
@pytest.mark.parametrize("w", fk.W_BUCKETS)
def test_band_cull_kernels_equal_plain(cuda, wire, w):
    """dequant_boxes bit-equal to the plain dequant and boxes, band_jlist
    byte-equal (all 128 columns) to the plain builder, at every band
    width on both wires: a 3-atom structure, tiles with no real atom and
    bands past both ends of the chunk."""
    structures = _study.band_structures(w, seed=w)
    max_nt = max(-(-s[0].shape[0] // 128) for s in structures)
    assert next(b for b in fk.W_BUCKETS if b >= max_nt) == w
    arrays, tm, _ = _study.band_chunk_wire(structures, wire)
    arrays = fk.to_device(arrays, cuda)
    tmeta = fk.to_device((tm,), cuda)[0]
    _kernels.reset_launch_counts()
    planes, qvalid, boxes = getattr(_kernels, f"dequant_{wire}")(*arrays)
    jlist = _kernels.band_jlist(planes, qvalid, tmeta, boxes, w)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["dequant_boxes"] == 1
    assert _kernels.launch_counts["band_jlist"] == 1
    want_planes, want_qvalid = getattr(fk, f"dequant_{wire}_reference")(
        *arrays)
    assert torch.equal(_bits(planes), _bits(want_planes))
    assert torch.equal(qvalid, want_qvalid)
    want_boxes = fk.tile_boxes_reference(want_planes, want_qvalid)
    for got, want in zip(boxes, want_boxes):
        assert torch.equal(_bits(got), _bits(want))
    for got, want in zip(_kernels.tile_boxes(planes, qvalid), want_boxes):
        assert torch.equal(_bits(got), _bits(want))
    # The dequant that writes no boxes (the host-cull route's).
    bare_planes, bare_qvalid = _launched(
        "dequant_boxes", lambda: getattr(fk, f"dequant_{wire}")(*arrays))
    assert torch.equal(_bits(bare_planes), _bits(want_planes))
    assert torch.equal(bare_qvalid, want_qvalid)
    want = fk.build_jlist_banded_reference(want_planes, want_qvalid, tmeta,
                                           w=w)
    assert torch.equal(jlist, want)
    assert torch.equal(fk.build_jlist_banded(planes, qvalid, tmeta, w=w),
                       want)
    # Tail entries past the chunk's ends, and the padding tiles' rows.
    t = tmeta.shape[0]
    j = ((jlist[:, 1:].to(torch.int64) & 0xFFFF) ^ 0x8000) - 0x8000
    assert bool(((j < 0) | (j >= t)).any())
    assert not bool(jlist[-_study.BAND_PAD_TILES:, 0].any())


@pytest.mark.parametrize("wire", ["q13", "q16"])
def test_banded_wrappers_launch_three_kernels(cuda, wire):
    """One banded wrapper call: one launch each of dequant_boxes,
    band_jlist and fused_count, and counts equal to the plain chain's at
    every real slot; the host-cull q16 wrapper launches dequant_boxes and
    fused_count."""
    structures = _study.band_structures(32, seed=3)
    arrays, tm, offsets = _study.band_chunk_wire(structures, wire)
    wire_d = fk.to_device((*arrays, tm), cuda)
    sphere = engine._sphere_device(100, cuda)
    banded = getattr(fk, f"fused_sasa_{wire}_banded")
    _kernels.reset_launch_counts()
    got = banded(*wire_d, sphere, n_points=100, w=32)
    torch.cuda.synchronize()
    assert {k: v for k, v in _kernels.launch_counts.items() if v} == {
        "dequant_boxes": 1, "band_jlist": 1, "fused_count": 1}
    planes, qvalid = getattr(fk, f"dequant_{wire}_reference")(*wire_d[:-1])
    jlist = fk.build_jlist_banded_reference(planes, qvalid, wire_d[-1], w=32)
    want = fk._counts_out(fk.fused_counts_reference(planes, jlist, sphere),
                          100)
    real = _study.real_slots(offsets, planes.shape[1], cuda)
    assert got.dtype == want.dtype == torch.uint8
    assert torch.equal(got[real], want[real])
    assert bool(((got[real] > 0) & (got[real] < 100)).any())
    if wire == "q16":
        _kernels.reset_launch_counts()
        host = fk.fused_sasa_q16(wire_d[0], wire_d[1], jlist, sphere,
                                 n_points=100)
        torch.cuda.synchronize()
        assert {k: v for k, v in _kernels.launch_counts.items() if v} == {
            "dequant_boxes": 1, "fused_count": 1}
        assert torch.equal(host[real], want[real])


def test_engine_banded_chunks_launch_each_kernel_once(cuda):
    """Every banded chunk the engine dispatches runs one dequant_boxes and
    one band_jlist; host-cull q16 chunks run dequant_boxes alone."""
    structures = _structures([90, 400, 1300], seed=5)
    structures.append(_structures([260], seed=6, spread=120.0)[0])  # q16
    eng = engine.BatchedSasaEngine(device=cuda)
    _kernels.reset_launch_counts()
    eng.compute(structures)
    c = eng.routes.counts
    assert c["q13"] >= 1 and c["q16"] >= 1
    assert _kernels.launch_counts["band_jlist"] == c["q13"] + c["q16"]
    assert _kernels.launch_counts["dequant_boxes"] == (
        c["q13"] + c["q16"] + c["host_q16"])


def test_band_launchers_refuse_bad_launches(cuda):
    planes = torch.zeros((8, 256), device=cuda)
    qvalid = torch.zeros(256, dtype=torch.bool, device=cuda)
    boxes = _kernels.tile_boxes(planes, qvalid)
    tmeta = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="band width 128"):
        _kernels.band_jlist(planes, qvalid, tmeta, boxes, 128)
    with pytest.raises(ValueError, match="qvalid is on cpu"):
        _kernels.band_jlist(planes, qvalid.cpu(), tmeta, boxes, 16)
    jlist = _kernels.band_jlist(planes, qvalid, tmeta, boxes, 16)
    assert torch.equal(jlist, fk.build_jlist_banded_reference(
        planes, qvalid, tmeta, w=16))
    assert (boxes.tmin == 3e4).all() and (boxes.tmaxr == 0).all()


@pytest.fixture(scope="module")
def neighbor_cases():
    return {name: (packed, gid, k)
            for name, packed, gid, k in _study.neighbor_cases()}


@pytest.mark.parametrize("name", _study.neighbor_case_names())
def test_neighbor_cells_byte_equal_plain(cuda, neighbor_cases, name):
    """The cell-list kernel against the plain neighbor phase on the
    smoke's seeded cases: counts and max_count equal, each row the same
    set of record bit patterns (the K nearest where the ball's rows
    overflow), and the list path's SASA from either set byte-equal."""
    packed, gid, k = neighbor_cases[name]
    packed, gid = torch.from_numpy(packed).to(cuda), torch.from_numpy(gid).to(
        cuda)
    before = dict(_kernels.launch_counts)
    got = neighbors.neighbor_records(packed, gid, probe=1.4, k=k)
    torch.cuda.synchronize()
    for name_ in ("cell_keys", "neighbor_cells"):
        assert _kernels.launch_counts[name_] == before[name_] + 1
    want = neighbors.neighbor_records_reference(packed, gid, probe=1.4, k=k)
    assert _study.records_differ(got, want) == []
    sphere = engine._sphere_device(100, cuda)
    sasa = [neighbors.records_sasa(rec, packed, gid, sphere, probe=1.4,
                                   n_points=100) for rec in (got, want)]
    assert torch.equal(sasa[0], sasa[1])


@pytest.fixture(scope="module")
def order_batches(neighbor_cases):
    """{name: (packed, gid)} of the seeded neighbor and ordering cases."""
    cases = {name: case[:2] for name, case in neighbor_cases.items()}
    cases.update((name, (packed, gid))
                 for name, packed, gid in _study.order_cases())
    return cases


@pytest.mark.parametrize("name", (*_study.neighbor_case_names(),
                                  *_study.ORDER_CASE_NAMES, "1jz8"))
def test_cell_keys_bit_equal_cell_grid(cuda, order_batches, name):
    """The binning kernel's keys, max_r and cell edges bit-equal to the
    plain binning's, and the ordering kernel's sorted keys, perm, sorted
    packed and sorted gid to a stable torch.sort and its gathers: one
    launch."""
    if name == "1jz8":
        packed, gid, _k = _largest_list_case()
    else:
        packed, gid = order_batches[name]
    packed, gid = (torch.from_numpy(a).to(cuda) for a in (packed, gid))
    before = _kernels.launch_counts["cell_keys"]
    got = _kernels.cell_keys(packed, gid, 1.4)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["cell_keys"] == before + 1
    want = neighbors.cell_order_reference(packed.cpu(), gid.cpu(), 1.4)
    for field, g, w in zip(want._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert torch.equal(g.cpu().view(torch.uint8),
                           w.view(torch.uint8)), field


def test_cell_keys_orders_runs_past_the_registers(cuda):
    """A structure of N = 49,152 slots (40,000 atoms, the rest padding):
    its cluster's 64 warps each order a run of 768 slots, past the 16
    steps a warp holds in registers, so each pass loads its run twice;
    and two such structures with an empty one between them."""
    rng = np.random.default_rng(49)
    n = 49_152
    packed = np.zeros((3, n, 4), np.float32)
    packed[..., :3] = rng.uniform(0.0, 120.0, (3, n, 3))
    packed[..., 3] = rng.choice(RADII, (3, n))
    gid = np.tile(np.arange(n, dtype=np.int32), (3, 1))
    gid[:, 40_000:] = -1
    gid[1] = -1
    for b in (1, 3):
        p, g = (torch.from_numpy(a[:b]).to(cuda) for a in (packed, gid))
        got = _launched("cell_keys", lambda: _kernels.cell_keys(p, g, 1.4))
        want = neighbors.cell_order_reference(p.cpu(), g.cpu(), 1.4)
        for field, x, w in zip(want._fields, got, want):
            assert torch.equal(x.cpu().view(torch.uint8),
                               w.view(torch.uint8)), (b, field)


def test_cell_keys_checks_before_any_launch_on_the_card(cuda):
    """Bad batches on the card raise before the binning kernel launches."""
    packed = torch.zeros((2, 8, 4), device=cuda)
    gid = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    before = dict(_kernels.launch_counts)
    for args, error in (
            ((packed.double(), gid), TypeError),
            ((packed, gid.long()), TypeError),
            ((packed[:, :, :3].contiguous(), gid), ValueError),
            ((packed.transpose(0, 1).contiguous().transpose(0, 1), gid),
             ValueError),
            ((torch.zeros(65, device=cuda)[1:].view(2, 8, 4), gid),
             ValueError),
            ((torch.zeros((0, 8, 4), device=cuda),
              torch.zeros((0, 8), dtype=torch.int32, device=cuda)),
             ValueError),
            ((torch.zeros((512, 1, 4), device=cuda),
              torch.zeros((512, 1), dtype=torch.int32, device=cuda)),
             ValueError),
            ((packed, gid.cpu()), ValueError)):
        with pytest.raises(error):
            _kernels.cell_keys(*args, 1.4)
    torch.cuda.synchronize()
    assert _kernels.launch_counts == before


def _largest_list_case():
    """1jz8 packed as the list path packs it, at its first K."""
    from rustsasa_tpu_torch.scripts import layout_probe

    return _study.list_batch(layout_probe.LIST_STRUCTURE)


def test_neighbor_cells_on_the_largest_structure(cuda, monkeypatch):
    """1jz8 through neighbor_records on the card, with the plain binning,
    torch's sorts and index_select and the plain neighbor phase made to
    raise: one cell_keys and one neighbor_cells launch, records equal to
    the plain version's (counts, max_count, each row's records, the
    fill)."""
    packed, gid, k = (torch.from_numpy(a).to(cuda) if isinstance(
        a, np.ndarray) else a for a in _largest_list_case())
    want = neighbors.neighbor_records_reference(packed, gid, probe=1.4, k=k)

    def refuse(*args, **kw):
        raise AssertionError("the CUDA route took a plain version")

    before = dict(_kernels.launch_counts)
    with monkeypatch.context() as patch:
        for name in ("cell_grid", "cell_order_reference", "_neighbor_phase",
                     "neighbor_records_reference"):
            patch.setattr(neighbors, name, refuse)
        for name in ("topk", "sort", "argsort", "index_select"):
            patch.setattr(torch, name, refuse)
        for name in ("sort", "argsort", "index_select"):
            patch.setattr(torch.Tensor, name, refuse)
        got = neighbors.neighbor_records(packed, gid, probe=1.4, k=k)
        torch.cuda.synchronize()
    for name in ("cell_keys", "neighbor_cells"):
        assert _kernels.launch_counts[name] == before[name] + 1
    assert _study.records_differ(got, want) == []
    assert int(got[2]) <= k


def test_list_batches_launch_one_neighbor_kernel_each(cuda):
    """Every list batch, re-runs included, is one neighbor kernel and one
    occlusion kernel."""
    structures = _structures([40, 300, 900], seed=21)
    rng = np.random.default_rng(0)
    structures.append((rng.normal(0, 2.5, (300, 3)).astype(np.float32),
                       np.full(300, 1.8, np.float32), None))  # overflows K
    eng = engine.BatchedSasaEngine(device=cuda, backend="list")
    _kernels.reset_launch_counts()
    got = eng.compute(structures)
    launches = _kernels.launch_counts
    assert launches["neighbor_cells"] == launches["list_occlusion"] == (
        launches["cell_keys"]) == (
        eng.routes.counts["list"]) == 4  # three buckets and one re-run
    want = engine.BatchedSasaEngine(device="cpu",
                                    backend="list").compute(structures)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cuda_list_route_never_takes_the_plain_phase(cuda, monkeypatch):
    """On the card no list route calls the plain neighbor phase or
    torch.topk: calculate_sasa_internal, the engine, graft_entry's step
    and the sharded step."""
    from rustsasa_tpu_torch import graft_entry
    from rustsasa_tpu_torch.parallel import mesh

    def refuse(*args, **kw):
        raise AssertionError("the plain neighbor phase ran on the card")

    monkeypatch.setattr(torch, "topk", refuse)
    monkeypatch.setattr(neighbors, "_neighbor_phase", refuse)
    monkeypatch.setattr(neighbors, "neighbor_records_reference", refuse)
    monkeypatch.setattr(neighbors, "cell_grid", refuse)
    structures = _structures([60, 500], seed=4)
    _kernels.reset_launch_counts()
    engine.calculate_sasa_internal(*structures[1][:2], backend="list",
                                   device=cuda)
    engine.BatchedSasaEngine(device=cuda, backend="list").compute(structures)
    fn, args = graft_entry.entry(cuda)
    fn(*args)
    packed, gid, sphere = graft_entry._example_batch(b=4, n=128)
    mesh.make_sharded_sasa([cuda, cuda], k=64, n_points=100)(packed, gid,
                                                              sphere)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["neighbor_cells"] == (
        _kernels.launch_counts["list_occlusion"]) == (
        _kernels.launch_counts["cell_keys"]) == 6


def test_neighbor_cells_launcher_refuses_bad_inputs(cuda):
    b, n = 2, 16
    args = {
        "packed": torch.zeros((b, n, 4), device=cuda),
        "group_id": torch.zeros((b, n), dtype=torch.int32, device=cuda),
        "max_r": torch.zeros(b, device=cuda),
        "keys": torch.zeros(b * n, dtype=torch.int64, device=cuda),
        "sorted_keys": torch.zeros(b * n, dtype=torch.int64, device=cuda),
        "perm": torch.zeros(b * n, dtype=torch.int64, device=cuda),
        "sorted_packed": torch.zeros((b * n, 4), device=cuda),
        "sorted_gid": torch.zeros(b * n, dtype=torch.int32, device=cuda),
    }
    before = _kernels.launch_counts["neighbor_cells"]
    for name, bad, error in (
            ("packed", args["packed"].cpu(), ValueError),
            ("group_id", args["group_id"].long(), TypeError),
            ("perm", args["perm"][:-1], ValueError),
            ("max_r", args["max_r"].double(), TypeError),
            ("sorted_packed", args["sorted_packed"][:-1], ValueError),
            ("sorted_gid", args["sorted_gid"].cpu(), ValueError)):
        with pytest.raises(error):
            _kernels.neighbor_cells(**{**args, name: bad}, probe=1.4, k=4)
    with pytest.raises(ValueError):
        _kernels.neighbor_cells(**args, probe=1.4, k=n + 1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _kernels.neighbor_cells(**{k: t.cpu() for k, t in args.items()},
                                probe=1.4, k=4)
    with pytest.raises(ValueError, match="is on cpu"):
        _kernels.cell_keys(args["packed"], args["group_id"].cpu(), 1.4)
    assert _kernels.launch_counts["neighbor_cells"] == before
    planes, counts, max_count = _kernels.neighbor_cells(**args, probe=1.4,
                                                        k=4)
    torch.cuda.synchronize()
    assert planes.shape == (4, 4, b * n) and counts.shape == (b * n,)
    assert max_count.shape == () and int(max_count) == 0


WARM_KERNELS = ("dequant_boxes", "band_jlist", "fused_count")


@pytest.mark.parametrize("threads", [None, 1])
def test_warm_shapes_launches_each_kernel_once_a_shape_an_entry(cuda,
                                                                threads):
    """warm_shapes: every production shape once on each ring entry (two
    streams of one card here), one launch of each of the banded chunk's
    three kernels a shape and entry, and the elapsed seconds back."""
    eng = engine.BatchedSasaEngine(devices=[cuda, cuda])
    shapes = eng._WARM_SHAPES
    _kernels.reset_launch_counts()
    elapsed = eng.warm_shapes(threads=threads)
    torch.cuda.synchronize()
    assert elapsed > 0.0
    assert {k: _kernels.launch_counts[k] for k in WARM_KERNELS} == dict.fromkeys(
        WARM_KERNELS, 2 * len(shapes))
    assert sum(_kernels.launch_counts.values()) == 3 * 2 * len(shapes)
    assert eng.routes.counts == dict.fromkeys(eng.routes.NAMES, 0)


def test_chunk_after_warming_equals_one_before(cuda):
    """A chunk's counts after warm_shapes (allocator blocks the all-padding
    chunks used) byte-equal to the same chunk's before."""
    structures = _structures([700, 2600, 3700], seed=11)
    structures.append(_structures([300], seed=12, spread=120.0)[0])  # q16
    eng = engine.BatchedSasaEngine(device=cuda)

    def counts():
        return [np.asarray(v.counts).copy()
                for v in eng.enqueue(structures).collect_views()]

    before = counts()
    assert eng.warm_shapes([(4096, 16), (524288, 32)], threads=1) > 0.0
    after = counts()
    assert eng.routes.counts["q13"] == 2 and eng.routes.counts["q16"] == 2
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)


# Run from a copy of the package whose build directory cannot be
# created (its parent, site/build, is a file, which no user, root
# included, can make a directory under).
BUILD_ELSEWHERE = """
import os
from rustsasa_tpu_torch.ops import _kernels, engine
from rustsasa_tpu_torch.utils import build_cache
want = os.path.join(os.environ["HOME"], ".cache", "rustsasa_tpu_torch")
assert _kernels.BUILD_DIR == build_cache.USER_DIR == want, _kernels.BUILD_DIR
built = _kernels.build()
assert sorted(built) == sorted(_kernels.SOURCES), sorted(built)
assert all(os.path.dirname(b.path) == want for b in built.values())
eng = engine.BatchedSasaEngine(device="cuda:0")
assert eng.warm_shapes([(4096, 16)]) > 0.0
assert _kernels.launch_counts["fused_count"] == 1
print(len(built))
"""


def test_kernels_build_in_the_user_cache_when_the_package_dir_is_read_only(
        cuda, tmp_path):
    """An installed copy of the package whose build directory cannot be
    written builds every kernel source into ~/.cache/rustsasa_tpu_torch,
    and the banded chunk's kernels launch from there."""
    import os
    import shutil
    import subprocess
    import sys

    site = tmp_path / "site"
    shutil.copytree(pathlib.Path(_kernels.__file__).resolve().parents[1],
                    site / "rustsasa_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (site / "build").write_text("")
    home = tmp_path / "home"
    home.mkdir()
    env = dict(os.environ, HOME=str(home), PYTHONPATH=str(site))
    proc = subprocess.run([sys.executable, "-c", BUILD_ELSEWHERE],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[-1]) == len(_kernels.SOURCES)
    built = sorted(p.name for p in (home / ".cache" / "rustsasa_tpu_torch")
                   .glob("lib*.so"))
    assert len(built) == len(_kernels.SOURCES)
