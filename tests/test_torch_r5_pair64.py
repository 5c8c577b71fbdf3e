"""Parity of the port's round-5 count-kernel study with the reference
script `scripts/r5_pair64.py` (CPU).

The same numpy inputs, made from a seed, go through the script's device
builders and Pallas kernels (in TPU interpret mode) and through
`rustsasa_tpu_torch.scripts.r5_pair64` (plain torch on the CPU).  Every
comparison is exact.  The kernels are fed the same dequantized planes:
the script's jitted `pair64_banded` / `nibble_banded` wrappers dequantize
inline, where XLA-CPU contracts `q * scale + origin` to a fused
multiply-add.  The plain models of the card's kernels on kernel 1's
layout - nibble, which packs an entry's groups four to a reach-test
chunk (`nibble_counts_kept_reference`), and pair64, whose CTAs stage
only their half's entries and chunks (`pair64_counts_kept_reference`) -
must give the plain versions' counts at every slot: for every group
count, on near-tangent pairs and pairs at the reach slack's edge, and on
entries admitted by one half, by neither, or past the chunk's end.  The
CUDA kernels are held against the same plain versions on the card
(tests/test_torch_cuda.py).
"""

import importlib.util

import jax
import numpy as np
import pytest
pytest.importorskip("torch")
import torch
from jax.experimental.pallas import tpu as pltpu

from conftest import REPO_ROOT
from rustsasa_tpu.ops import fused_kernel as ref
from rustsasa_tpu.ops.engine import _sphere_packed
from rustsasa_tpu_torch.ops import _kernels
from rustsasa_tpu_torch.ops import fused_kernel as port
from rustsasa_tpu_torch.scripts import _study, r5_pair64

PROBE = 1.4
RADII = np.array([1.4, 1.55, 1.6, 1.7, 1.8, 1.9, 2.0], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def script():
    """scripts/r5_pair64.py, loaded by path (it is no package module)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_r5_pair64", REPO_ROOT / "scripts" / "r5_pair64.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _structures(sizes, seed, spread=25.0):
    rng = np.random.default_rng(seed)
    return [
        ((rng.uniform(0, spread, (n, 3)) + 60.0).astype(np.float32),
         rng.choice(RADII, n), np.arange(n, dtype=np.int32))
        for n in sizes
    ]


def _planes(seed=1):
    """Dequantized q16 planes of a 5-tile chunk (100 + 400 atoms)."""
    planes4, tp, tm, offsets = ref._pack_structures_q16_numpy(
        _structures([100, 400], seed=seed), PROBE
    )
    planes, qvalid = port.dequant_q16(*port.to_device((planes4, tp), "cpu"))
    assert planes.shape[1] == 5 * 128
    return planes, qvalid, tm, offsets


def _sphere(n_points):
    packed = _sphere_packed(n_points)
    s128 = np.zeros((packed.shape[0], 128), np.float32)
    s128[:, 0:4] = packed
    return torch.from_numpy(packed), s128


@pytest.mark.parametrize("w", [16, 32])
def test_builder_2h_byte_equal_script(script, w):
    planes, qvalid, tm, _ = _planes()
    got = r5_pair64.build_jlist_banded_2h(planes, qvalid, torch.from_numpy(tm),
                                          w=w)
    want = jax.jit(lambda p, v, t: script.build_jlist_banded_2h(p, v, t, w=w))(
        planes.numpy(), qvalid.numpy(), tm
    )
    for g, x in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    # Some mask A has bit 15 set, i.e. its entry is negative as int32, and
    # some entry admits groups for one half only.
    jlist_a, jmask_b = (g.numpy() for g in got)
    assert (jlist_a[:, 1:] < 0).any()
    mask_a = (jlist_a[:, 1:].astype(np.int64) & 0xFFFFFFFF) >> 16
    assert (mask_a != jmask_b[:, 1:]).any()


@pytest.mark.parametrize("w", [16, 32])
def test_builder_nibble_byte_equal_script(script, w):
    planes, qvalid, tm, _ = _planes(seed=2)
    got = r5_pair64.build_jlist_nibble(planes, qvalid, torch.from_numpy(tm),
                                       w=w)
    want, _count = jax.jit(
        lambda p, v, t: script._build_masks(p, v, t, w=w)
    )(planes.numpy(), qvalid.numpy(), tm)
    assert len(got) == len(want) == 3
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    # Their live entries decode to build_jlist_banded's (the cells past a
    # row's count hold the sort's inactive tail, which no kernel reads).
    decoded = r5_pair64._nibble_masks(*got).numpy()
    banded = port.build_jlist_banded(planes, qvalid, torch.from_numpy(tm),
                                     w=w).numpy()
    np.testing.assert_array_equal(decoded[:, 0], banded[:, 0])
    live = np.arange(port.JLIST_CAP) < banded[:, 0:1]
    np.testing.assert_array_equal(decoded[:, 1:][live], banded[:, 1:][live])


def test_pack_nibbles_every_mask(script):
    masks = np.arange(1 << 16, dtype=np.int32)
    got = r5_pair64._pack_nibbles(torch.from_numpy(masks).to(torch.int64))
    want = jax.jit(script._pack_nibbles)(masks)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), np.asarray(x))
    # Groups 8-15: group 15 in list position 7 wraps w1 negative.
    assert int(got[0][0xFF00].to(torch.int32)) == np.int32(-0x1234568)


@pytest.mark.parametrize("kernel", ["pair64", "nibble"])
def test_counts_reference_byte_equal_pallas(script, kernel):
    planes, qvalid, tm, offsets = _planes(seed=3)
    packed, s128 = _sphere(100)
    tmeta = torch.from_numpy(tm)
    if kernel == "pair64":
        lists = r5_pair64.build_jlist_banded_2h(planes, qvalid, tmeta, w=16)
        got = r5_pair64.pair64_counts_reference(planes, *lists, packed)
        with pltpu.force_tpu_interpret_mode():
            want = script._counts_call_2h(
                planes.numpy(), *(t.numpy() for t in lists), s128
            )
    else:
        lists = r5_pair64.build_jlist_nibble(planes, qvalid, tmeta, w=16)
        got = r5_pair64.nibble_counts_reference(planes, *lists, packed)
        with pltpu.force_tpu_interpret_mode():
            want = script._counts_call_nibble(
                planes.numpy(), tuple(t.numpy() for t in lists), s128
            )
    want = np.asarray(want).reshape(-1).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    # Kernel 1's counts on its own j-lists, at every slot.
    prod = port.fused_counts_reference(
        planes, port.build_jlist_banded(planes, qvalid, tmeta, w=16), packed
    )
    np.testing.assert_array_equal(got.numpy(), prod.numpy())
    real = got[_study.real_slots(offsets, planes.shape[1], "cpu")]
    assert ((real > 0) & (real < 100)).any() and int(real.max()) <= 100


def _nibble_words(groups):
    """(gcount, w1, w2) of a list of group ids, as int32 words."""
    w1 = w2 = 0
    for n, g in enumerate(groups):
        if n < 8:
            w1 |= g << (4 * n)
        else:
            w2 |= g << (4 * (n - 8))
    as_i32 = (lambda w: w - (1 << 32) if w >= 1 << 31 else w)
    return len(groups), as_i32(w1), as_i32(w2)


def test_nibble_chunk_rows_pack_four_groups_a_chunk():
    groups = [1, 3, 4, 9, 14, 15, 2, 15, 0]  # 15 at position 7: w1 < 0
    gcount, w1, w2 = _nibble_words(groups)
    assert w1 < 0
    jl = torch.zeros((1, 128), dtype=torch.int32)
    jl[0, 0], jl[0, 1] = 1, (gcount << 16) | 0
    words = [torch.zeros_like(jl), torch.zeros_like(jl)]
    words[0][0, 1], words[1][0, 1] = w1, w2
    rows = r5_pair64.nibble_chunk_rows(jl, *words, 0, 0)
    assert rows.shape == (3, 32)  # ceil(9 / 4) chunks
    for c in range(3):
        for o in range(4):
            n = 4 * c + o
            want = (8 * groups[n] + torch.arange(8) if n < gcount
                    else torch.full((8,), -1))
            assert torch.equal(rows[c, 8 * o:8 * o + 8], want), (c, o)


def _nibble_lists(t, seed):
    """(jl, w1, w2) [t, 128] i32: each tile's 18 entries over the chunk's
    tiles, with group counts 1-16 of distinct sorted ids, a list naming
    group 15 at position 7 (w1 < 0), one naming a group twice and one of
    all 16 groups; gcount 16 of 17 stored (read as 16)."""
    rng = np.random.default_rng(seed)
    lists = [sorted(rng.choice(16, n, replace=False).tolist())
             for n in range(1, 17)]
    lists[7] = [0, 1, 2, 3, 4, 5, 6, 15]
    lists += [[5, 5, 9], list(range(16))]
    jl = np.zeros((t, 128), np.int64)
    w1 = np.zeros_like(jl)
    w2 = np.zeros_like(jl)
    for ti in range(t):
        jl[ti, 0] = len(lists)
        for e, groups in enumerate(lists):
            gcount, a, b = _nibble_words(groups)
            if e == len(lists) - 1:
                gcount = 17
            jl[ti, 1 + e] = (gcount << 16) | ((ti + e) % t)
            w1[ti, 1 + e], w2[ti, 1 + e] = a, b
    return tuple(torch.from_numpy(x.astype(np.int32)) for x in (jl, w1, w2))


# The card's nibble kernel visits an entry's groups as packed chunks
# (nibble_chunk_rows) and streams the rows a warp's reach skip keeps: its
# model gives the plain version's counts at every slot.
@pytest.mark.parametrize("lists", ["builder", "every_gcount"])
def test_nibble_packed_model_equals_plain(lists):
    planes, qvalid, tm, _ = _planes(seed=3)
    packed, _s128 = _sphere(100)
    if lists == "builder":
        jl, w1, w2 = r5_pair64.build_jlist_nibble(
            planes, qvalid, torch.from_numpy(tm), w=16)
    else:
        jl, w1, w2 = _nibble_lists(planes.shape[1] // 128, seed=5)
        assert (w1 < 0).any()
    got = r5_pair64.nibble_counts_kept_reference(planes, jl, w1, w2, packed)
    want = r5_pair64.nibble_counts_reference(planes, jl, w1, w2, packed)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int(want.max()) > 0 and int(want.min()) < 100


def _split_halves(jlist, t, seed):
    """(jlist_a, jmask_b, plain_a, plain_b) from kernel 1's j-list
    [T, 128] i32 admitting every group: per tile, entry 1 admitted by
    atoms 0-63 only and entry 2 by 64-127 only (random masks), entry 0
    by both with random masks, the rest by both in full; then one entry
    with both masks 0 and one on a j-tile past the chunk's end (t + 3,
    all groups).  plain_a, plain_b are the same lists with the past entry
    dead (masks 0), as the kernel takes it and the plain version needs."""
    rng = np.random.default_rng(seed)
    ent = jlist.astype(np.int64) & 0xFFFFFFFF
    n = ent[:, 0].copy()
    a = ent.copy()
    b = np.zeros_like(ent)
    b[:, 0] = n
    for ti in range(jlist.shape[0]):
        k = int(n[ti])
        masks = np.full((k, 2), 0xFFFF, np.int64)
        masks[0] = rng.integers(1, 1 << 16, 2)
        masks[1] = (rng.integers(1, 1 << 16), 0)
        masks[2] = (0, rng.integers(1, 1 << 16))
        a[ti, 1:1 + k] = (masks[:, 0] << 16) | (ent[ti, 1:1 + k] & 0xFFFF)
        b[ti, 1:1 + k] = masks[:, 1]
        a[ti, 1 + k] = ti  # both masks 0
        a[ti, 2 + k] = (0xFFFF << 16) | (t + 3)
        b[ti, 2 + k] = 0xFFFF
        a[ti, 0] = b[ti, 0] = k + 2
    plain_a, plain_b = a.copy(), b.copy()
    for ti in range(jlist.shape[0]):
        k = int(a[ti, 0])
        plain_a[ti, k] &= 0xFFFF
        plain_b[ti, k] = 0
    return tuple(torch.from_numpy(x.astype(np.uint32).view(np.int32)
                                  .astype(np.int32))
                 for x in (a, b, plain_a, plain_b))


# The card's pair64 kernel stages, per CTA, only its half's live entries
# and tests kernel 1's reach chunks of its half's groups: its model gives
# the plain version's counts at every slot.
@pytest.mark.parametrize("case", ["builder", "tangent", "slack_edge"])
def test_pair64_kept_model_equals_plain(case):
    packed, _s128 = _sphere(100)
    if case == "builder":
        planes, qvalid, tm, _ = _planes(seed=3)
        jlist_a, jmask_b = r5_pair64.build_jlist_banded_2h(
            planes, qvalid, torch.from_numpy(tm), w=16)
        lists = plain = (jlist_a, jmask_b)
        mask_a = (jlist_a[:, 1:].long() & 0xFFFFFFFF) >> 16
        assert ((mask_a == 0) != (jmask_b[:, 1:] == 0)).any()
    else:
        planes_np, jlist, _real = _study.tangent_chunk(
            100, seed=6, far=case == "slack_edge")
        planes = torch.from_numpy(planes_np)
        *lists, pa, pb = _split_halves(jlist, planes.shape[1] // 128, seed=7)
        plain = (pa, pb)
    got = r5_pair64.pair64_counts_kept_reference(planes, *lists, packed)
    want = r5_pair64.pair64_counts_reference(planes, *plain, packed)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int(want.max()) > 0 and int(want.min()) < 100


def test_pair64_kept_model_sees_each_half_mask():
    """Dropping an entry's mask B moves atoms 64-127's counts only (and
    the kept model follows the plain version there too)."""
    planes_np, jlist, _real = _study.tangent_chunk(100, seed=8)
    planes = torch.from_numpy(planes_np)
    packed, _s128 = _sphere(100)
    jlist_a, jmask_b, *_ = _split_halves(jlist, planes.shape[1] // 128,
                                         seed=9)
    full = r5_pair64.pair64_counts_kept_reference(planes, jlist_a, jmask_b,
                                                  packed)
    cut = jmask_b.clone()
    cut[:, 1:] = 0
    half_a = r5_pair64.pair64_counts_kept_reference(planes, jlist_a, cut,
                                                    packed)
    lane = torch.arange(planes.shape[1]) % 128
    assert torch.equal(half_a[lane < 64], full[lane < 64])
    assert (half_a[lane >= 64] >= full[lane >= 64]).all()
    assert (half_a[lane >= 64] > full[lane >= 64]).any()


def test_pair64_staged_counts_entries_and_chunks_a_cta():
    # One tile of a 2-tile chunk: entries with masks (A, B) of groups
    # ({0}, {0, 4}), ({0..15}, none), (none, {12}), (none, none), and one
    # past the chunk; kernel 1's union masks {0, 4}, all, {12}.
    masks = [(0x1, 0x11), (0xFFFF, 0x0), (0x0, 0x1000), (0x0, 0x0),
             (0x3, 0x3)]
    jlist_a = torch.zeros((2, 128), dtype=torch.int64)
    jmask_b = torch.zeros((2, 128), dtype=torch.int64)
    jlist = torch.zeros((2, 128), dtype=torch.int64)
    jlist_a[0, 0] = jmask_b[0, 0] = jlist[0, 0] = len(masks)
    for e, (ma, mb) in enumerate(masks):
        j = 9 if e == 4 else e % 2
        jlist_a[0, 1 + e] = (ma << 16) | j
        jmask_b[0, 1 + e] = mb
        jlist[0, 1 + e] = ((ma | mb) << 16) | j
    as_i32 = (lambda x: (x - ((x >> 31) << 32)).to(torch.int32))
    got = r5_pair64.pair64_staged(as_i32(jlist), as_i32(jlist_a),
                                  as_i32(jmask_b))
    # Mask A: 2 live entries, 1 + 4 chunks; mask B: 2 entries, 2 + 1
    # chunks; kernel 1: 3 entries, 2 + 4 + 1 chunks; over 2 tiles.
    assert got == {"pair64": {"entries": (2 + 2) / 4, "chunks": (5 + 3) / 4},
                   "prod": {"entries": 3 / 2, "chunks": 7 / 2}}


def test_reach_chunks_count_packed_and_kernel1_chunks():
    # Kernel 1's entries: masks of groups {0}, {0, 5}, {0, 4, 8, 12}, all
    # 16, and one on a tile past the chunk; the nibble list of the same
    # groups packs them into 1, 1, 1 and 4 chunks.
    masks = [0x1, 0x21, 0x1111, 0xFFFF, 0x3]
    jlist = torch.zeros((2, 128), dtype=torch.int64)
    jlist[0, 0] = len(masks)
    for e, mask in enumerate(masks):
        jlist[0, 1 + e] = (mask << 16) | (9 if e == 4 else e % 2)
    jlist = (jlist - ((jlist >> 31) << 32)).to(torch.int32)
    assert r5_pair64.reach_chunks(jlist) == (1 + 2 + 4 + 4, 4)
    jl = torch.zeros((2, 128), dtype=torch.int32)
    jl[0, 0] = len(masks)
    for e, mask in enumerate(masks):
        jl[0, 1 + e] = (bin(mask).count("1") << 16) | (9 if e == 4 else e % 2)
    assert r5_pair64.reach_chunks(jl, nibble=True) == (1 + 1 + 1 + 4, 4)


def test_run_on_cpu_equals_prod():
    result = r5_pair64.run(_structures([90, 300, 500], seed=4), "cpu", w=16,
                           slots=1280, reps=1)
    assert result["tiles"] == 1 + 3 + 4
    variants = result["variants"]
    assert list(variants) == ["prod", "nibble", "pair64"]
    for v in variants.values():
        assert v["max_dcount"] == 0
        assert v["ms"] > 0 and v["margins"] > 0
    prod, pair64 = variants["prod"], variants["pair64"]
    assert variants["nibble"]["margins"] == prod["margins"]
    assert pair64["j_atoms_per_atom"] < prod["j_atoms_per_atom"]
    per_entry = variants["nibble"]["chunks_per_entry"]
    assert 1.0 <= per_entry["nibble"] <= per_entry["prod"] <= 4.0
    assert variants["nibble"]["instr"] == pair64["instr"] == prod["instr"]
    staged = pair64["per_cta"]
    assert 0 < staged["pair64"]["entries"] <= staged["prod"]["entries"]
    assert 0 < staged["pair64"]["chunks"] <= staged["prod"]["chunks"]
    assert set(result["builders"]) == {"banded", "banded_kernel",
                                       "banded_2h", "nibble"}
    assert result["kernel_equal"]


def test_count_wrappers_refuse_cpu_and_other_devices():
    planes = torch.zeros((8, 128))
    jl = torch.zeros((1, 128), dtype=torch.int32)
    sphere = torch.zeros((104, 4))
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.pair64_count(planes, jl, jl, sphere)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.nibble_count(planes, jl, jl, jl, sphere)
    meta = planes.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        r5_pair64.pair64_counts(meta, jl, jl, sphere)


def test_load_corpus_skips_large_structures_and_fills_slots():
    triples = _study.load_corpus(slots=60_000, max_tiles=12)
    tiles = [-(-t[0].shape[0] // 128) for t in triples]
    assert triples and max(tiles) <= 12
    assert 60_000 - 12 * 128 < 128 * sum(tiles) <= 60_000
    # The same selection as the engine's host route makes.
    coords, radii, gids = triples[0]
    assert coords.dtype == radii.dtype == np.float32
    assert coords.shape == (radii.shape[0], 3) == (gids.shape[0], 3)
