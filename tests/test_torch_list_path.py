"""The PyTorch port's neighbor-list path against the JAX reference (CPU).

The same numpy inputs, made from a seed, go through
`rustsasa_tpu.ops.engine` / `rustsasa_tpu.ops.pallas_kernel` and the
port's `rustsasa_tpu_torch.ops.neighbors` / `.engine`:

  * kernel: the port's plain-torch occlusion against the Pallas
    `_occlusion_tile_kernel` in interpret mode, byte for byte;
  * module: the neighbor phase's candidate counts, neighbor sets, v and
    limit, exactly, in the dense and the row-chunked branch;
  * path: per-atom SASA against the reference's list path ("xla") at the
    reference's own tolerance, atol 1e-3;
  * analytic: the closed-form cases of tests/test_sanity.py at 50,000
    points, rtol 0.005.

The CUDA kernel is held against the same plain-torch version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustsasa_tpu.ops.engine as ref_engine
from rustsasa_tpu.ops import pallas_kernel
from rustsasa_tpu_torch.ops import _kernels
from rustsasa_tpu_torch.ops import engine as port_engine
from rustsasa_tpu_torch.ops import neighbors

PROBE = 1.4
NEG_BIG = np.float32(-1e30)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and each process's spinning OpenMP threads would fight the
    others' for the same cores (a 1 s test took 300 s that way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cluster(n, seed, spread=12.0):
    """tests/test_pallas.py's random cluster."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, spread, size=(n, 3)).astype(np.float32) + 100.0
    radii = rng.uniform(1.4, 1.9, size=n).astype(np.float32)
    return coords, radii


def _records(n, k, seed):
    """Seeded neighbor records in the neighbor phase's form: v = c_i - c_j
    for random neighbours, limit from their radii, -1e30 past each row's
    random candidate count; area factors and per-tile bounds to match."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-6.0, 6.0, (n, k, 3)).astype(np.float32)
    r_i = rng.uniform(2.8, 3.3, n).astype(np.float32)
    r_j = rng.uniform(2.8, 3.3, (n, k)).astype(np.float32)
    v2 = (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]
    limit = ((r_j * r_j - v2) - (r_i * r_i)[:, None]) / (2.0 * r_i[:, None])
    counts = rng.integers(0, k + 1, n)
    limit = np.where(np.arange(k)[None, :] < counts[:, None], limit, NEG_BIG)
    area = (np.float32(4.0 * np.pi / 100.0) * r_i * r_i).astype(np.float32)
    kmax = np.clip(counts.reshape(-1, 128).max(axis=1), 0, k).astype(np.int32)
    return v, limit.astype(np.float32), area, kmax


@pytest.mark.parametrize("n", [128, 384])
@pytest.mark.parametrize("n_points", [60, 100, 256])
def test_occlusion_reference_byte_equal_pallas(n, n_points):
    v, limit, area, kmax = _records(n, 48, seed=n + n_points)
    packed = ref_engine._sphere_packed(n_points)  # P = 64, 104, 256
    sphere128 = pallas_kernel.pack_sphere(packed[:, 0:3], packed[:, 3] > 0)
    want = np.asarray(pallas_kernel.occlusion_sasa_pallas(
        v, limit, area, sphere128, kmax, interpret=True
    ))
    got = neighbors.occlusion_sasa(
        torch.from_numpy(v), torch.from_numpy(limit), torch.from_numpy(area),
        torch.from_numpy(packed), torch.from_numpy(kmax),
    ).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # Neither all buried nor all exposed: the inputs exercise the test.
    full = area * np.float32(n_points)
    assert (got > 0).any() and (got < full).any()


def test_occlusion_reference_stops_at_tile_bound():
    # Records past a tile's bound are never read, even where they would
    # occlude: the bound is the kernel's loop limit.
    v, limit, area, kmax = _records(256, 16, seed=3)
    kmax = np.array([0, 16], np.int32)
    packed = ref_engine._sphere_packed(100)
    args = [torch.from_numpy(a) for a in (v, limit, area, packed, kmax)]
    got = neighbors.occlusion_sasa(*args).numpy()
    np.testing.assert_array_equal(got[:128], area[:128] * np.float32(100.0))
    assert (got[128:] < area[128:] * np.float32(100.0)).any()


@pytest.mark.parametrize("p", [1, 64, 104, 128, 129, 960, 5000, 50_000])
def test_list_point_plan_covers_every_point_once(p):
    """csrc/list_occlusion.cu's work items: blocks of at most 128 points,
    each split into two halves of at most 64 (a thread's two occlusion
    words), as the kernel cuts them from the plan; P <= 128 is one
    block."""
    blocks, pb, hp = _kernels.list_point_plan(p)
    assert blocks == -(-p // 128) and pb <= 128 and hp <= 64
    covered = np.zeros(p, np.int64)
    for b in range(blocks):
        b0, b1 = b * pb, min(p, b * pb + pb)
        for h in range(2):
            lo = min(b1, b0 + h * hp)
            hi = min(b1, lo + hp)
            assert 0 <= hi - lo <= hp
            covered[lo:hi] += 1
    assert (covered == 1).all()
    with pytest.raises(ValueError):
        _kernels.list_point_plan(0)


def test_list_instr_per_triple_counts_the_loops_ops():
    """The bound's count per (point, atom, k) triple: the dot's 3 mul and
    2 add and one compare folded into the point's predicate."""
    ops = ["mul"] * 3 + ["add"] * 2 + ["setp_or"]
    assert _kernels.LIST_INSTR_PER_TRIPLE == len(ops)


def _neighbor_inputs(n, seed, spread=40.0, pad=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, spread, (n, 3)).astype(np.float32) + 50.0
    r = rng.uniform(1.4, 1.9, n).astype(np.float32)
    packed = np.zeros((n + pad, 4), np.float32)
    packed[:n, 0:3] = c
    packed[:n, 3] = r
    gid = np.full(n + pad, -1, np.int32)
    gid[:n] = np.arange(n, dtype=np.int32)
    gid[7] = gid[3]  # one shared group id: those two never pair
    return packed, gid


def _neighbor_sets(v, limit):
    """Per row: the valid neighbours' v, sorted, and their limits in the
    same order, so that top-k tie order does not matter."""
    out = []
    for vr, lr in zip(v, limit):
        ok = lr > NEG_BIG
        order = np.lexsort(vr[ok].T[::-1])
        out.append((vr[ok][order], lr[ok][order]))
    return out


def _port_phase(packed, gid, k):
    return [a.numpy() for a in neighbors._neighbor_phase(
        torch.from_numpy(packed), torch.from_numpy(gid), probe=PROBE, k=k
    )]


@pytest.mark.parametrize("branch", ["dense", "row_chunked"])
def test_neighbor_phase_matches_reference(branch, monkeypatch):
    packed, gid = _neighbor_inputs(1000, seed=5, pad=24)  # 1,024 rows
    k = 64
    dense = _port_phase(packed, gid, k)
    if branch == "row_chunked":
        for mod in (ref_engine, neighbors):
            monkeypatch.setattr(mod, "_DENSE_N_LIMIT", 256)
            monkeypatch.setattr(mod, "_ROW_CHUNK", 256)
    rv, rl, rc, rmc = (np.asarray(a) for a in ref_engine._neighbor_phase(
        packed, gid, probe=PROBE, k=k
    ))
    pv, pl, pc, pmc = _port_phase(packed, gid, k)
    # The port's two branches are one computation, bit for bit.
    for a, b in zip((pv, pl, pc, pmc), dense):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pc, rc)
    assert int(pmc) == int(rmc) <= k  # no overflow: every candidate kept
    assert pv.shape == rv.shape and pl.shape == rl.shape
    assert (pc[:1000] > 0).all() and (pc[1000:] == 0).all()
    for (gv, gl), (wv, wl) in zip(_neighbor_sets(pv, pl),
                                  _neighbor_sets(rv, rl)):
        np.testing.assert_array_equal(gv, wv)
        if branch == "dense":
            np.testing.assert_array_equal(gl, wl)
        else:
            # The reference compiles its row blocks (lax.map), and
            # XLA-CPU contracts |v|^2 into fused multiply-adds there:
            # limits move by an ulp.  Its own dense-vs-chunked test
            # (tests/test_engine.py) holds them to atol 1e-4.
            np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-5)


def _ref_list(structures, n_points=100):
    return ref_engine.BatchedSasaEngine(
        ref_engine.SasaParams(n_points=n_points), backend="xla"
    ).compute(structures)


@pytest.mark.parametrize("n", [128, 300])
def test_calculate_sasa_internal_list_matches_reference(n):
    coords, radii = _cluster(n, seed=n)
    want = ref_engine.calculate_sasa_internal(coords, radii, backend="xla")
    got = port_engine.calculate_sasa_internal(
        coords, radii, backend="list", device="cpu"
    )
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert got.dtype == np.float32 and (want > 0).any()


@pytest.mark.parametrize("sizes", [(100, 180, 256), (0, 5, 100, 700)])
def test_batched_list_matches_reference(sizes):
    structures = []
    for i, n in enumerate(sizes):
        coords, radii = _cluster(n, seed=10 + i, spread=20.0)
        structures.append((coords, radii, None))
    engine = port_engine.BatchedSasaEngine(backend="list", device="cpu")
    got = engine.compute(structures)
    want = _ref_list(structures)
    assert [len(g) for g in got] == list(sizes)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-3)
    # One batch per padded size, no K overflow at this density.
    n_buckets = len({neighbors._round_bucket(n, neighbors._N_BUCKETS)
                     for n in sizes if n})
    assert engine.routes.counts["list"] == n_buckets


def test_overflow_rerun_matches_reference(monkeypatch):
    """tests/test_engine.py's dense ball: hundreds of candidates per atom
    overflow the first K; the re-run with a larger K must be exact."""
    rng = np.random.default_rng(0)
    coords = rng.normal(0, 2.5, (300, 3)).astype(np.float32)
    radii = np.full(300, 1.8, np.float32)
    calls = []
    single = neighbors._sasa_single

    def spy(*args, k, **kw):
        calls.append(k)
        return single(*args, k=k, **kw)

    monkeypatch.setattr(neighbors, "_sasa_single", spy)
    got = port_engine.calculate_sasa_internal(
        coords, radii, backend="list", device="cpu"
    )
    assert len(calls) == 2 and calls[1] > calls[0]
    want = ref_engine.calculate_sasa_internal(coords, radii, backend="xla")
    np.testing.assert_allclose(got, want, atol=1e-3)
    engine = port_engine.BatchedSasaEngine(backend="list", device="cpu")
    batched = engine.compute([(coords, radii, None)])[0]
    np.testing.assert_allclose(batched, want, atol=1e-3)
    assert engine.routes.counts["list"] == 2  # the first K, then the re-run


def _area(r):
    return 4.0 * math.pi * r * r


def _cap(r, d):
    return 2.0 * math.pi * r * (r - d / 2.0)


R = 2.0 + PROBE
# tests/test_sanity.py's closed-form cases: (atoms, group ids, expected).
ANALYTIC = {
    "single_sphere": ([(0, 0, 0, 2.0)], None, [_area(R)]),
    "two_non_overlapping": (
        [(0, 0, 0, 2.0), (10, 0, 0, 2.0)], None, [_area(R)] * 2),
    "two_overlapping": (
        [(0, 0, 0, 2.0), (4, 0, 0, 2.0)], None, [_area(R) - _cap(R, 4.0)] * 2),
    "contained": ([(0, 0, 0, 10.0), (2, 0, 0, 2.0)], None, [_area(11.4), 0.0]),
    "three_linear": (
        [(0, 0, 0, 2.0), (5, 0, 0, 2.0), (10, 0, 0, 2.0)], None,
        [_area(R) - _cap(R, 5.0), _area(R) - 2 * _cap(R, 5.0),
         _area(R) - _cap(R, 5.0)]),
    "same_group_id": (
        [(0, 0, 0, 2.0), (0.5, 0, 0, 2.0)], [7, 7], [_area(R)] * 2),
}


@pytest.mark.parametrize("case", sorted(ANALYTIC))
def test_analytic_cases_at_50000_points(case):
    atoms, gids, expected = ANALYTIC[case]
    coords = np.array([a[:3] for a in atoms], np.float32)
    radii = np.array([a[3] for a in atoms], np.float32)
    got = port_engine.calculate_sasa_internal(
        coords, radii, group_ids=None if gids is None else np.array(gids),
        probe_radius=PROBE, n_points=50_000, device="cpu",
    )
    assert got.shape == (len(atoms),)
    for g, e in zip(got, expected):
        if e == 0.0:
            assert g == pytest.approx(0.0, abs=0.005)
        else:
            assert g == pytest.approx(e, rel=0.005)


def test_list_and_fused_backends_agree():
    # The list path on f32 coordinates against the fused path on the q13
    # wire: tests/test_pallas.py's bound for quantized against f32 input.
    coords, radii = _cluster(300, seed=21)
    fused = port_engine.calculate_sasa_internal(
        coords, radii, backend="fused", device="cpu"
    )
    listed = port_engine.calculate_sasa_internal(
        coords, radii, backend="list", device="cpu"
    )
    np.testing.assert_allclose(fused, listed, atol=3.0)
    reference = ref_engine.BatchedSasaEngine(
        backend="fused_interpret", readback_dtype=jnp.float32
    ).compute([(coords, radii, None)])[0]
    np.testing.assert_array_equal(fused, reference)
