"""Parity of the port's round-5 count-kernel study with the reference
script `scripts/r5_pair64.py` (CPU).

The same numpy inputs, made from a seed, go through the script's device
builders and Pallas kernels (in TPU interpret mode) and through
`rustsasa_tpu_torch.scripts.r5_pair64` (plain torch on the CPU).  Every
comparison is exact.  The kernels are fed the same dequantized planes:
the script's jitted `pair64_banded` / `nibble_banded` wrappers dequantize
inline, where XLA-CPU contracts `q * scale + origin` to a fused
multiply-add.  The CUDA kernels are held against the same plain versions
on the card (tests/test_torch_cuda.py).
"""

import importlib.util

import jax
import numpy as np
import pytest
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
    assert set(result["builders"]) == {"banded", "banded_2h", "nibble"}


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
