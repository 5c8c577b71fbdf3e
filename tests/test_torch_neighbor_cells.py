"""The list path's neighbor phase in the port, on the CPU.

On the card `neighbors.neighbor_records` bins a [B, N] batch into cells
and orders the atoms by cell (`ops/csrc/neighbor_cells.cu`'s
`cell_keys`: the keys, their stable sort and the atoms gathered into
that order) and launches the file's cell-list kernel; on the CPU it
takes the plain version, the dense expansion and top-k of
`_neighbor_phase` structure by structure.  Here:

  * the explicit fused multiply-add chain of the cross term against
    `torch.matmul` and the JAX package's HIGHEST dot, bit for bit;
  * `cell_grid` (the plain version of `cell_keys`) against a NumPy model
    of the kernel's f64 operations in its order, bit for bit, on the
    seeded cases of `scripts/_study.neighbor_cases` and 1jz8;
  * a CPU model of the kernel's warp scan, fed the keys, sort, sorted
    atoms and radii the launcher passes it, against the plain version
    on the seeded cases (far offsets, a long thin structure, pairs at
    the cutoff, an overflowing ball): every plain candidate lies in one
    of its row's 27 cells, and the model's counts and kept records (the
    K nearest where a row overflows) are the plain version's, each in
    the slot of its visit order;
  * a CPU model of the ordering kernel (`_cell_order_model`:
    the dense cell index, its LSD digit passes over the structure's
    warp runs, the structure offsets) against `torch.sort(keys,
    stable=True)` on cells shared by many atoms, many structures with
    padding between them, a structure with no real atom, a span that
    needs the 54-bit index, 511 structures, the seeded cases and 1jz8;
  * the cell edge's bound, the padding keys, the record comparison the
    card checks use, and every argument check of the two launchers,
    which runs before the device check and so on CPU tensors.

The kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from rustsasa_tpu_torch.ops import _kernels, neighbors
from rustsasa_tpu_torch.ops.fma import dot3
from rustsasa_tpu_torch.scripts import _study

PROBE = 1.4
OFFSETS = (1000.0, -1000.0, 1300.0, -1300.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cases():
    return {name: (torch.from_numpy(packed), torch.from_numpy(gid), k)
            for name, packed, gid, k in _study.neighbor_cases(
                offsets=OFFSETS)}


@pytest.mark.parametrize("offset", [100.0, 1000.0, -1300.0])
def test_fma_chain_equals_matmul_and_highest_dot(offset):
    rng = np.random.default_rng(int(offset) & 0xFFFF)
    c = (rng.uniform(-40.0, 40.0, (400, 3)) + offset).astype(np.float32)
    ct = torch.from_numpy(c)
    chain = dot3(ct[:, None, 0], ct[None, :, 0], ct[:, None, 1],
                 ct[None, :, 1], ct[:, None, 2], ct[None, :, 2])
    assert torch.equal(chain, torch.matmul(ct, ct.T))
    highest = np.asarray(jnp.dot(c, c.T, precision=jax.lax.Precision.HIGHEST,
                                 preferred_element_type=jnp.float32))
    np.testing.assert_array_equal(chain.numpy(), highest)
    # The plain sequential sum rounds differently on many pairs: the
    # chain is not a reordering that could pass unnoticed.
    seq = (ct[:, None, 0] * ct[None, :, 0] + ct[:, None, 1] * ct[None, :, 1]
           ) + ct[:, None, 2] * ct[None, :, 2]
    assert not torch.equal(chain, seq)


def _decode(keys):
    """(structure, cell x, y, z) of cell keys."""
    m = neighbors.CELL_MAX
    return (keys >> 54, (keys >> 36) & m, (keys >> 18) & m, keys & m)


def _kernel_model(packed, gid, k):
    """csrc/neighbor_cells.cu's rows, computed on the CPU from the keys,
    sort, sorted atoms and radii the launcher passes the kernel: each
    real row visits the nine cell columns around its own in the kernel's
    order (dx, then dy, each column z-1..z+1 one range of the sorted
    keys), laid end to end; tests each visited atom of the sorted
    gather as the plain version does; gives each candidate the slot of
    its place among the row's candidates in that order (the warp's
    ballot prefix), and on overflow keeps the K smallest (d2 bits,
    index), in visit order.  Returns ((planes, counts, max_count) in
    neighbor_records' form, every row's plain candidates all visited, the
    atoms each row visited)."""
    b, n = gid.shape
    m = b * n
    kk = min(k, n)
    grid = neighbors.cell_order_reference(packed, gid, PROBE)
    sorted_keys, perm = grid.sorted_keys, grid.perm
    spacked, sgid = grid.sorted_packed, grid.sorted_gid
    planes = torch.zeros((4, kk, m + (-m % 4)), dtype=torch.float32)
    planes[3] = neighbors._NEG_BIG
    counts = torch.zeros(m, dtype=torch.int32)
    visits = torch.zeros(m, dtype=torch.int64)
    covered = True
    _s, cx, cy, cz = _decode(grid.keys)
    for s in range(b):
        coords, radii, g = packed[s, :, :3], packed[s, :, 3], gid[s]
        _d2, cand = neighbors._candidates(coords, radii, g, coords, g,
                                          grid.max_r[s], PROBE)
        cut = (radii + grid.max_r[s]) + 2.0 * PROBE
        thr = cut * cut + neighbors._CUTOFF_SLACK
        for i in range(n):
            row = s * n + i
            if g[i] < 0:
                continue
            ranges = []
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    x, y = int(cx[row]) + dx, int(cy[row]) + dy
                    if not (0 <= x <= neighbors.CELL_MAX
                            and 0 <= y <= neighbors.CELL_MAX):
                        continue
                    col = (s << 54) | (x << 36) | (y << 18)
                    lo = max(int(cz[row]) - 1, 0)
                    hi = min(int(cz[row]) + 1, neighbors.CELL_MAX)
                    ranges.append(torch.arange(
                        int(torch.searchsorted(sorted_keys, col | lo)),
                        int(torch.searchsorted(sorted_keys, col | hi,
                                               right=True))))
            ps = torch.cat(ranges)
            visits[row] = ps.numel()
            d2 = neighbors._pair_d2(coords[i][None], spacked[ps, :3])
            ok = (sgid[ps] != g[i]) & (d2 <= thr[i])
            ps, d2 = ps[ok], d2[ok]
            js = (perm[ps] - s * n).tolist()
            covered &= set(js) == set(torch.nonzero(cand[i]).flatten()
                                      .tolist())
            counts[row] = len(js)
            if len(js) > kk:
                order = sorted(range(len(js)), key=lambda t: (
                    int(d2[t].view(torch.int32)), js[t]))
                ps = ps[sorted(order[:kk])]
            if not ps.numel():
                continue
            v, limit = neighbors._records(
                coords[i:i + 1], radii[i:i + 1], spacked[ps, :3][None],
                spacked[ps, 3][None], PROBE)
            planes[:3, :ps.numel(), row] = v[0].T
            planes[3, :ps.numel(), row] = limit[0]
    return (planes, counts, counts.max()), covered, visits


@pytest.mark.parametrize("name", _study.neighbor_case_names(OFFSETS))
def test_kernel_model_equals_plain(cases, name):
    packed, gid, k = cases[name]
    want = neighbors.neighbor_records_reference(packed, gid, probe=PROBE,
                                                k=k)
    got, covered, visits = _kernel_model(packed, gid, k)
    assert covered, "a plain candidate lies outside its row's 27 cells"
    # The bound's count of visited pairs (chip_smoke.py) is the model's.
    keys = neighbors.cell_grid(packed, gid, PROBE).keys
    assert torch.equal(_study.visited_pairs(
        keys, torch.sort(keys, stable=True).values), visits)
    assert _study.records_differ(got, want) == []
    assert int(want[2]) > 0
    if name == "ball":
        assert int(want[2]) > want[0].shape[1]  # rows overflow K


def _cell_keys_model(packed, gid, probe):
    """csrc/neighbor_cells.cu's cell_keys in NumPy, one f64 operation at
    a time in the kernel's order -> (keys [B*N], max_r [B] f32, h [B])."""
    b, n = gid.shape
    keys = np.full(b * n, neighbors.PAD_KEY, np.int64)
    max_r = np.zeros(b, np.float32)
    h = np.zeros(b)
    for s in range(b):
        real = np.flatnonzero(gid[s] >= 0)
        c32 = packed[s, real, :3]
        if real.size:
            max_r[s] = max(np.float32(0.0), packed[s, real, 3].max())
            lo, hi = (a.astype(np.float64) for a in (c32.min(0), c32.max(0)))
        else:
            lo = hi = np.zeros(3)
        c = c32.astype(np.float64)
        r2 = ((c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]) + c[:, 2] * c[:, 2])
        r2 = max(0.0, r2.max()) if real.size else 0.0
        span = max(hi[0] - lo[0], hi[1] - lo[1], hi[2] - lo[2])
        cut = 2.0 * np.float64(max_r[s]) + 2.0 * probe
        thr = cut * cut + 1e-3
        edge = np.sqrt((thr + 2.0 ** -19 * (r2 + thr)) * (1.0 + 2.0 ** -20))
        h[s] = max(edge, span / float(neighbors.CELL_MAX - 1))
        cell = np.clip(np.floor((c - lo) / h[s]), 0,
                       neighbors.CELL_MAX).astype(np.int64)
        keys[s * n + real] = ((s << 54) | (cell[:, 0] << 36)
                              | (cell[:, 1] << 18) | cell[:, 2])
    return keys, max_r, h


@pytest.mark.parametrize("name", (*_study.neighbor_case_names(OFFSETS),
                                  *_study.ORDER_CASE_NAMES, "1jz8"))
def test_cell_grid_equals_the_cell_keys_model(cases, name):
    """The plain binning takes the kernel's f64 operations in its order:
    keys, max_r and h bit-equal to the model of cell_keys (in max_batch
    torch's own f64 sqrt on the CPU would leave two edges an ulp low)."""
    if name in _study.ORDER_CASE_NAMES:
        packed, gid = _order_case(name)
    elif name == "1jz8":
        from rustsasa_tpu_torch.scripts import layout_probe

        packed, gid = (torch.from_numpy(a) for a in _study.list_batch(
            layout_probe.LIST_STRUCTURE)[:2])
    else:
        packed, gid, _k = cases[name]
    grid = neighbors.cell_grid(packed, gid, PROBE)
    keys, max_r, h = _cell_keys_model(packed.numpy(), gid.numpy(), PROBE)
    np.testing.assert_array_equal(grid.keys.numpy(), keys)
    np.testing.assert_array_equal(grid.max_r.numpy().view(np.int32),
                                  max_r.view(np.int32))
    np.testing.assert_array_equal(grid.h.numpy().view(np.int64),
                                  h.view(np.int64))


@pytest.mark.parametrize("name", _study.neighbor_case_names(OFFSETS))
def test_candidates_lie_in_adjacent_cells(cases, name):
    """Every pair the plain version makes candidates sits in the same
    structure and at most one cell apart on every axis."""
    packed, gid, _k = cases[name]
    b, n = gid.shape
    grid = neighbors.cell_grid(packed, gid, PROBE)
    s, cx, cy, cz = (t.reshape(b, n) for t in _decode(grid.keys))
    pairs = 0
    for i in range(b):
        coords = packed[i, :, :3]
        _d2, cand = neighbors._candidates(coords, packed[i, :, 3], gid[i],
                                          coords, gid[i], grid.max_r[i],
                                          PROBE)
        rows, cols = torch.nonzero(cand, as_tuple=True)
        assert (s[i, rows] == i).all() and (s[i, cols] == i).all()
        for c in (cx[i], cy[i], cz[i]):
            assert bool(((c[rows] - c[cols]).abs() <= 1).all())
        pairs += rows.numel()
    assert pairs > 0


def test_cell_edge_bound():
    """h^2 covers the widest cutoff plus the expansion's error bound at
    the structure's largest |c|, grows with it, and a span too wide for
    2^18 cells widens h instead."""
    rng = np.random.default_rng(3)
    packed = np.zeros((3, 64, 4), np.float32)
    packed[:, :, 3] = 1.6
    packed[0, :, :3] = rng.uniform(0, 20, (64, 3))
    packed[1, :, :3] = rng.uniform(0, 20, (64, 3)) + 1300.0
    packed[2, :, :3] = rng.uniform(0, 1, (64, 3))
    packed[2, 0, :3] = -1e6
    packed[2, 1, :3] = 1e6
    gid = np.tile(np.arange(64, dtype=np.int32), (3, 1))
    gid[0, 60:] = -1
    packed[0, 60:, :3] = 1e7  # padding: neither in R nor in the span
    grid = neighbors.cell_grid(torch.from_numpy(packed),
                               torch.from_numpy(gid), PROBE)
    thr = (2 * 1.6 + 2 * PROBE) ** 2 + 1e-3
    r2 = (packed[1, :, :3].astype(np.float64) ** 2).sum(axis=1).max()
    assert grid.h[0] ** 2 >= thr * (1 + 2 ** -20)
    assert grid.h[0] ** 2 < thr + 0.01
    assert grid.h[1] ** 2 >= thr + 2.0 ** -19 * (r2 + thr)
    assert grid.h[2] >= 2e6 / (neighbors.CELL_MAX - 1)
    cells = torch.stack(_decode(grid.keys)[1:])
    assert int(cells.max()) <= neighbors.CELL_MAX


def _full_cell_keys(b, n, seed):
    """Keys [B*N] of B structures whose real atoms take cells 0 and
    CELL_MAX on every axis (and random ones between): a dense index of
    54 bits, which cell_grid's edge never needs (its D2_ERR term keeps h
    >= 2^-9.5 max |c|, so at most ~2^10.5 cells an axis), but the
    ordering kernel takes."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, neighbors.CELL_MAX + 1, (b, n, 3))
    cells[:, 0] = 0
    cells[:, 1] = neighbors.CELL_MAX
    cells[:, 2:40] = cells[:, 2:3]  # ties
    keys = ((np.arange(b)[:, None] << 54) | (cells[..., 0] << 36)
            | (cells[..., 1] << 18) | cells[..., 2])
    keys[:, 41::4] = neighbors.PAD_KEY
    return torch.from_numpy(keys.reshape(b * n))


# cell_keys' ordering kernel (csrc/neighbor_cells.cu cell_order_kernel):
# a structure's CTAs (one a kClusterSlots slots, at most kCluster), the
# warps a CTA (each a run of slots), and the most bits a digit pass
# sorts (kDigitBits).
ORDER_CLUSTER = 8
ORDER_CLUSTER_SLOTS = 2048
ORDER_WARPS = 8
ORDER_DIGIT_BITS = 8


def _order_run(n: int) -> int:
    """The slots of each warp's run for a structure of n slots."""
    segments = min(-(-n // ORDER_CLUSTER_SLOTS), ORDER_CLUSTER) * ORDER_WARPS
    return -(-(-(-n // segments)) // 32) * 32


def _order_digits(cells: int) -> tuple[int, int]:
    """(passes, bits a pass) of cell_keys' LSD sort of the dense cell
    indices 0..cells (cells, the structure's nx ny nz, is its padding
    slots' index): the fewest passes of ORDER_DIGIT_BITS bits covering
    cells' bit length, split evenly."""
    bits = max(cells, 1).bit_length()
    passes = -(-bits // ORDER_DIGIT_BITS)
    return passes, -(-bits // passes)


def _stable_pass(digit, run: int):
    """One LSD pass as csrc/neighbor_cells.cu's ordering kernel runs it ->
    each slot's place: the slots of lower digits, then those of its digit
    in the runs of `run` slots before its own (in run order), then those
    before it in its own run."""
    n = digit.shape[0]
    bins = 1 << ORDER_DIGIT_BITS
    runs = -(-n // run)
    hot = torch.zeros((runs * run, bins), dtype=torch.int64)
    hot[torch.arange(n), digit] = 1
    hot = hot.reshape(runs, run, bins)
    counts = hot.sum(dim=1)  # [runs, bins]
    lower = torch.cumsum(counts.sum(dim=0), 0) - counts.sum(dim=0)
    earlier_runs = torch.cumsum(counts, 0) - counts
    within = (torch.cumsum(hot, 1) - hot).reshape(runs * run, bins)[:n]
    r = torch.arange(n) // run
    return (lower[digit] + earlier_runs[r, digit]
            + within[torch.arange(n), digit])


def _cell_order_model(keys, b: int, n: int):
    """CPU model of cell_keys' ordering kernel on the keys [B*N] i64 ->
    (sorted_keys, perm) [B*N] i64: per structure the dense cell index d =
    (cx ny + cy) nz + cz of its occupied cells (n* = the largest cell +
    1; padding d = nx ny nz), sorted in _order_digits' LSD passes, each
    stable over the warps' runs of whole 32-slot steps (_order_run,
    _stable_pass); then structure s's real atoms after those of the
    structures before it, and every padding slot after all real atoms,
    in index order.  Must equal torch.sort(keys, stable=True)."""
    keys = keys.reshape(b, n)
    pad = keys == neighbors.PAD_KEY
    real = (~pad).sum(dim=1)
    real_before = torch.cumsum(real, 0) - real
    real_all = int(real.sum())
    run = _order_run(n)
    sorted_keys = torch.empty(b * n, dtype=torch.int64)
    perm = torch.empty(b * n, dtype=torch.int64)
    for s in range(b):
        field = [(keys[s] >> shift) & neighbors.CELL_MAX
                 for shift in (36, 18, 0)]
        dims = [int(f[~pad[s]].max()) + 1 if int(real[s]) else 1
                for f in field]
        cells = dims[0] * dims[1] * dims[2]
        d = (field[0] * dims[1] + field[1]) * dims[2] + field[2]
        d = torch.where(pad[s], cells, d)
        slots = torch.arange(n)
        passes, width = _order_digits(cells)
        for p in range(passes):
            digit = (d[slots] >> (p * width)) & ((1 << width) - 1)
            place = _stable_pass(digit, run)
            slots = torch.empty_like(slots).index_put_((place,), slots)
        at = torch.arange(n)
        r = int(real[s])
        before = int(real_before[s])
        dest = torch.where(at < r, before + at,
                           real_all + (s * n - before) + (at - r))
        sorted_keys[dest] = keys[s, slots]
        perm[dest] = s * n + slots
    return sorted_keys, perm


ORDER_CASES = (*_study.ORDER_CASE_NAMES, "full_cells", "1jz8")


def _order_case(name):
    """(packed [B, N, 4], gid [B, N]) of _study.order_cases' case or 1jz8."""
    if name == "1jz8":
        from rustsasa_tpu_torch.scripts import layout_probe

        packed, gid = _study.list_batch(layout_probe.LIST_STRUCTURE)[:2]
    else:
        packed, gid = {c[0]: c[1:] for c in _study.order_cases()}[name]
    return torch.from_numpy(packed), torch.from_numpy(gid)


@pytest.mark.parametrize("name", ORDER_CASES)
def test_order_model_equals_stable_sort(name):
    """The ordering kernel's passes give torch.sort(keys, stable=True)'s
    values and indices, ties in index order, padding after every real
    atom."""
    if name == "full_cells":
        b, n = 3, 500
        keys = _full_cell_keys(b, n, seed=11)
    else:
        packed, gid = _order_case(name)
        b, n = gid.shape
        keys = neighbors.cell_grid(packed, gid, PROBE).keys
    got = _cell_order_model(keys, b, n)
    want = torch.sort(keys, stable=True)
    assert torch.equal(got[0], want.values)
    assert torch.equal(got[1], want.indices)
    s, cx, cy, cz = _decode(keys)
    real = keys != neighbors.PAD_KEY
    if name == "shared_cells":  # one cell of 300 atoms, kept in index order
        cell = (keys == keys[100]).nonzero()[:, 0]
        assert cell.numel() >= 300 and torch.equal(
            want.indices[want.values == keys[100]], cell)
    if name == "empty_structure":
        assert not bool(real.reshape(b, n)[1].any())
    cells = [int(c[real].max()) + 1 for c in (cx, cy, cz)]
    product = cells[0] * cells[1] * cells[2]
    passes = {"full_cells": 7, "wide_span": 4, "1jz8": 2}
    if name in passes:
        assert _order_digits(product)[0] == passes[name]
    if name == "full_cells":
        assert (product - 1).bit_length() == 54


@pytest.mark.parametrize("name", _study.neighbor_case_names(OFFSETS))
def test_order_model_on_the_seeded_cases(cases, name):
    packed, gid, _k = cases[name]
    keys = neighbors.cell_grid(packed, gid, PROBE).keys
    got = _cell_order_model(keys, *gid.shape)
    want = torch.sort(keys, stable=True)
    assert torch.equal(got[0], want.values)
    assert torch.equal(got[1], want.indices)


def test_order_reference_gathers_at_the_sort():
    packed, gid = _order_case("many_structures")
    got = neighbors.cell_order_reference(packed, gid, PROBE)
    grid = neighbors.cell_grid(packed, gid, PROBE)
    assert got._fields == _kernels.CellOrder._fields
    for a, b in zip(got[:3], grid):
        assert torch.equal(a, b)
    assert torch.equal(got.sorted_keys, got.keys[got.perm])
    assert torch.equal(got.sorted_packed, packed.reshape(-1, 4)[got.perm])
    assert torch.equal(got.sorted_gid, gid.reshape(-1)[got.perm])
    real = int((gid >= 0).sum())
    assert (got.sorted_gid[:real] >= 0).all()
    assert (got.sorted_gid[real:] < 0).all()
    assert torch.equal(got.perm[real:], (gid.reshape(-1) < 0).nonzero()[:, 0])


def test_order_runs():
    """One CTA (8 warps) a 2,048 slots, at most 8: 1jz8's 32,768 slots
    in runs of 512 (16 steps), the ordering cases' small structures in
    one CTA's runs."""
    assert [_order_run(n) for n in (8, 96, 700, 2048, 2049, 32768, 65536)
            ] == [32, 32, 96, 256, 160, 512, 1024]


def test_order_digits():
    assert _order_digits(1) == (1, 1)
    assert _order_digits(255) == (1, 8)
    assert _order_digits(256) == (2, 5)
    assert _order_digits(22 ** 3) == (2, 7)
    assert _order_digits(2 ** 54) == (7, 8)


def test_padding_keys_sort_last():
    packed = torch.zeros((2, 8, 4))
    packed[..., 3] = 1.5
    gid = torch.full((2, 8), -1, dtype=torch.int32)
    gid[0, :3] = torch.arange(3)
    gid[1, :5] = torch.arange(5)
    packed[1, :5, 0] = torch.arange(5) * 50.0
    keys = neighbors.cell_grid(packed, gid, PROBE).keys.reshape(2, 8)
    assert (keys[gid < 0] == neighbors.PAD_KEY).all()
    real = keys[gid >= 0]
    assert int(real.max()) < neighbors.PAD_KEY
    assert ((real >> 54) == torch.tensor([0] * 3 + [1] * 5)).all()
    sorted_keys = torch.sort(keys.flatten(), stable=True).values
    assert (sorted_keys[8:] == neighbors.PAD_KEY).all()


def test_neighbor_records_take_the_plain_version_on_the_cpu(cases,
                                                            monkeypatch):
    packed, gid, k = cases["batch"]

    def launch(*args, **kw):
        raise AssertionError("the CPU route launched the kernel")

    monkeypatch.setattr(_kernels, "neighbor_cells", launch)
    monkeypatch.setattr(_kernels, "cell_keys", launch)
    got = neighbors.neighbor_records(packed, gid, probe=PROBE, k=k)
    want = neighbors.neighbor_records_reference(packed, gid, probe=PROBE,
                                                k=k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    planes, counts, mc = got
    assert planes.shape == (4, k, gid.numel()) and counts.dtype == torch.int32
    with pytest.raises(ValueError, match="unsupported device"):
        neighbors.neighbor_records(packed.to("meta"), gid.to("meta"),
                                   probe=PROBE, k=k)


def test_single_is_a_batch_of_one(cases):
    packed, gid, k = cases["groups"]
    sphere = torch.from_numpy(_sphere(100))
    single, mc1 = neighbors._sasa_single(packed[0], gid[0], sphere, k=k,
                                         n_points=100, probe=PROBE)
    batched, mc2 = neighbors._sasa_batched(packed, gid, sphere, k=k,
                                           n_points=100, probe=PROBE)
    assert torch.equal(single, batched[0]) and int(mc1) == int(mc2)
    assert single.shape == (gid.shape[1],) and (single[gid[0] < 0] == 0).all()


def _sphere(n_points):
    from rustsasa_tpu_torch.ops import engine

    return engine._sphere_packed(n_points)


def test_record_multisets_ignore_slot_order(cases):
    packed, gid, k = cases["groups"]
    planes, counts, mc = neighbors.neighbor_records_reference(
        packed, gid, probe=PROBE, k=k)
    shuffled = planes.clone()
    rng = torch.Generator().manual_seed(0)
    for row in range(counts.shape[0]):
        c = int(counts[row])
        shuffled[:, :c, row] = planes[:, torch.randperm(c, generator=rng),
                                      row]
    assert torch.equal(_study.record_multisets(planes, counts),
                       _study.record_multisets(shuffled, counts))
    # The kernel's own form: nothing but (0, 0, 0, -1e30) past the kept
    # records, and a flipped bit found.
    live = torch.arange(planes.shape[1])[:, None] < counts[None, :]
    clean = torch.where(live[None], shuffled, 0.0)
    clean[3] = torch.where(live, shuffled[3], neighbors._NEG_BIG)
    assert _study.records_differ((clean, counts, mc),
                                 (planes, counts, mc)) == []
    flipped = clean.clone()
    flipped.view(torch.int32)[3, 0, 0] ^= 1
    assert _study.records_differ((flipped, counts, mc),
                                 (planes, counts, mc)) == [
        "the rows' records differ"]
    assert "slots past" in _study.records_differ(
        (planes, counts, mc), (planes, counts, mc))[0]


def _launch_args(b=2, n=8, **over):
    args = {
        "packed": torch.zeros((b, n, 4)),
        "group_id": torch.zeros((b, n), dtype=torch.int32),
        "max_r": torch.zeros(b),
        "keys": torch.zeros(b * n, dtype=torch.int64),
        "sorted_keys": torch.zeros(b * n, dtype=torch.int64),
        "perm": torch.zeros(b * n, dtype=torch.int64),
        "sorted_packed": torch.zeros((b * n, 4)),
        "sorted_gid": torch.zeros(b * n, dtype=torch.int32),
    }
    args.update(over)
    return args


@pytest.mark.parametrize("over, k, error, match", [
    ({"packed": torch.zeros((2, 8, 4), dtype=torch.float64)}, 4, TypeError,
     "packed has dtype"),
    ({"group_id": torch.zeros((2, 8), dtype=torch.int64)}, 4, TypeError,
     "group_id has dtype"),
    ({"keys": torch.zeros(16, dtype=torch.int32)}, 4, TypeError,
     "keys has dtype"),
    ({"perm": torch.zeros(15, dtype=torch.int64)}, 4, ValueError,
     "perm shape"),
    ({"packed": torch.zeros((2, 8, 3))}, 4, ValueError, "packed shape"),
    ({"max_r": torch.zeros(3)}, 4, ValueError, "max_r shape"),
    ({"sorted_keys": torch.zeros((16, 1), dtype=torch.int64)}, 4,
     ValueError, "expected 1-D"),
    ({"packed": torch.zeros((2, 8, 4)).transpose(0, 1).contiguous()
      .transpose(0, 1)}, 4, ValueError, "contiguous"),
    ({}, 0, ValueError, "outside"),
    ({}, 9, ValueError, "outside"),
    ({"packed": torch.zeros(2 * 8 * 4 + 1)[1:].view(2, 8, 4)}, 4,
     ValueError, "16-byte"),
    ({"max_r": torch.zeros(2, device="meta")}, 4, ValueError, "is on meta"),
    ({"sorted_packed": torch.zeros((16, 4), dtype=torch.float64)}, 4,
     TypeError, "sorted_packed has dtype"),
    ({"sorted_packed": torch.zeros((16, 3))}, 4, ValueError,
     "sorted_packed shape"),
    ({"sorted_packed": torch.zeros(16 * 4 + 1)[1:].view(16, 4)}, 4,
     ValueError, "sorted_packed must start on a 16-byte"),
    ({"sorted_gid": torch.zeros(16, dtype=torch.int64)}, 4, TypeError,
     "sorted_gid has dtype"),
    ({"sorted_gid": torch.zeros(15, dtype=torch.int32)}, 4, ValueError,
     "sorted_gid shape"),
    ({"sorted_gid": torch.zeros(16, dtype=torch.int32, device="meta")}, 4,
     ValueError, "is on meta"),
])
def test_launcher_checks_before_any_launch(over, k, error, match):
    with pytest.raises(error, match=match):
        _kernels.neighbor_cells(**_launch_args(**over), probe=PROBE, k=k)


@pytest.mark.parametrize("packed, gid, error, match", [
    (torch.zeros((2, 8, 4), dtype=torch.float64),
     torch.zeros((2, 8), dtype=torch.int32), TypeError, "packed has dtype"),
    (torch.zeros((2, 8, 4)), torch.zeros((2, 8), dtype=torch.int64),
     TypeError, "group_id has dtype"),
    (torch.zeros((2, 8, 3)), torch.zeros((2, 8), dtype=torch.int32),
     ValueError, "packed shape"),
    (torch.zeros((2, 8, 4)), torch.zeros(16, dtype=torch.int32), ValueError,
     "expected 2-D"),
    (torch.zeros((8, 2, 4)).transpose(0, 1),
     torch.zeros((2, 8), dtype=torch.int32), ValueError, "contiguous"),
    (torch.zeros(2 * 8 * 4 + 1)[1:].view(2, 8, 4),
     torch.zeros((2, 8), dtype=torch.int32), ValueError, "16-byte"),
    (torch.zeros((2, 8, 4)), torch.zeros((2, 8), dtype=torch.int32,
                                         device="meta"),
     ValueError, "is on meta"),
    (torch.zeros((0, 8, 4)), torch.zeros((0, 8), dtype=torch.int32),
     ValueError, "structures"),
    (torch.zeros((2, 0, 4)), torch.zeros((2, 0), dtype=torch.int32),
     ValueError, "structures"),
    (torch.zeros((_kernels.MAX_CELL_BATCH + 1, 1, 4)),
     torch.zeros((_kernels.MAX_CELL_BATCH + 1, 1), dtype=torch.int32),
     ValueError, "structures"),
])
def test_cell_keys_checks_before_any_launch(packed, gid, error, match):
    before = dict(_kernels.launch_counts)
    with pytest.raises(error, match=match):
        _kernels.cell_keys(packed, gid, PROBE)
    assert _kernels.launch_counts == before


def test_cell_keys_needs_cuda_tensors():
    packed = torch.zeros((2, 8, 4))
    gid = torch.zeros((2, 8), dtype=torch.int32)
    before = dict(_kernels.launch_counts)
    with pytest.raises(ValueError, match="cell_keys needs CUDA tensors"):
        _kernels.cell_keys(packed, gid, PROBE)
    assert _kernels.launch_counts == before


def test_launcher_batch_limits():
    b = _kernels.MAX_CELL_BATCH + 1
    with pytest.raises(ValueError, match="structures"):
        _kernels.neighbor_cells(**_launch_args(b=b, n=1), probe=PROBE, k=1)
    with pytest.raises(ValueError, match="structures"):
        _kernels.neighbor_cells(**_launch_args(b=0), probe=PROBE, k=1)
    with pytest.raises(ValueError, match="at most"):
        neighbors.cell_grid(torch.zeros((b, 1, 4)),
                            torch.zeros((b, 1), dtype=torch.int32), PROBE)


def test_launcher_needs_cuda_tensors():
    before = dict(_kernels.launch_counts)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _kernels.neighbor_cells(**_launch_args(), probe=PROBE, k=8)
    assert _kernels.launch_counts == before
