"""The port's CUDA kernels against their plain-torch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rustsasa_tpu_torch.ops import _kernels, engine, neighbors
from rustsasa_tpu_torch.ops import fused_kernel as fk
from rustsasa_tpu_torch.scripts import (
    _study, kernel_experiments, r3_kernel_variants, r3_maxplus,
    r4_microkernel, r4_saturation, r5_pair64,
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
    assert torch.equal(got, want)
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
    assert _kernels.launch_counts["list_occlusion"] == eng.routes.counts["list"]
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
    passes, _k = _kernels.point_passes(sphere.shape[0])
    for wire in ((planes5, jlist), r4_saturation.buried_block_wire()):
        planes, jl = fk.to_device(wire, cuda)
        prod = fk.fused_counts(planes, jl, sphere)
        for check_every in (1, 2, 4):
            got, streamed = _launched(
                "saturation_count",
                lambda: r4_saturation.saturation_counts(
                    planes, jl, sphere, check_every=check_every),
            )
            want, want_streamed = r4_saturation.saturation_counts_reference(
                planes, jl, sphere, check_every=check_every
            )
            assert torch.equal(got, want) and torch.equal(got, prod)
            assert torch.equal(streamed, want_streamed)
            assert bool((streamed <= passes * jl[:, 0]).all())
    # The lattice's buried tile stops early in every pass; the shell's do not.
    assert int(streamed[0]) < passes * int(jl[0, 0])
    assert torch.equal(streamed[1:], passes * jl[1:, 0])


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
