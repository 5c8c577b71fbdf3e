"""Parity of the port's round-3 max-plus study with the reference script
`scripts/r3_maxplus.py` (CPU).

The same dequantized planes and j-lists go through the script's Pallas
kernel `mp_static_kernel` in TPU interpret mode (`run_variant`, variant
"mp_static"; its "base" variant hard-codes a compiled TPU call) and
through `rustsasa_tpu_torch.scripts.r3_maxplus` (plain torch on the CPU).
On XLA's CPU backend the kernel's K = 3 dot_generals and sum(c * c) are
fused multiply-add chains, which the port emulates exactly, so the counts
are byte-equal.  Against kernel 1, whose margin rounds differently, the
counts are held to at most MAX_FLIPS = 2 flipped points per atom
(__graft_entry__.py's bound), and the difference is reported.  The CUDA
kernel is held against the same plain version on the card
(tests/test_torch_cuda.py).
"""

import importlib.util

import jax
import jax.numpy as jnp
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
from rustsasa_tpu_torch.ops import fma
from rustsasa_tpu_torch.scripts import _study, r3_maxplus, r4_saturation

PROBE = 1.4
RADII = np.array([1.4, 1.55, 1.6, 1.7, 1.8, 1.9, 2.0], np.float32)
HI = jax.lax.Precision.HIGHEST


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def script():
    """scripts/r3_maxplus.py, loaded by path (it is no package module)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_r3_maxplus", REPO_ROOT / "scripts" / "r3_maxplus.py"
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


def _banded_wire():
    """Dequantized q16 planes of a 5-tile chunk (100 + 400 atoms) and
    build_jlist_banded's j-lists at w = 16, with the real-slot mask."""
    planes4, tp, tm, offsets = ref._pack_structures_q16_numpy(
        _structures([100, 400], seed=1), PROBE
    )
    planes, qvalid = port.dequant_q16(*port.to_device((planes4, tp), "cpu"))
    jlist = port.build_jlist_banded(planes, qvalid, torch.from_numpy(tm), w=16)
    return planes, jlist, _study.real_slots(offsets, planes.shape[1], "cpu")


def _lattice_wire():
    """The buried lattice block (host-cull f32 planes, full masks)."""
    planes, jlist = port.to_device(r4_saturation.buried_block_wire(), "cpu")
    return planes, jlist, planes[4] > 0.0


@pytest.mark.parametrize("wire", ["banded_q16", "buried_lattice"])
def test_counts_byte_equal_script(script, wire):
    planes, jlist, real = (_banded_wire if wire == "banded_q16"
                           else _lattice_wire)()
    packed = _sphere_packed(100)
    s128 = np.zeros((packed.shape[0], 128), np.float32)
    s128[:, 0:4] = packed
    sphere = torch.from_numpy(packed)
    full = np.zeros((port.N_PLANES, planes.shape[1]), np.float32)
    full[:planes.shape[0]] = planes.numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(script.run_variant(
            full, jlist.numpy(), s128, variant="mp_static"
        )).reshape(-1).astype(np.int32)
    got = r3_maxplus.maxplus_counts(planes, jlist, sphere)
    np.testing.assert_array_equal(got.numpy(), want)
    # Against kernel 1: a few boundary points flip, within the bound.
    prod = port.fused_counts_reference(planes, jlist, sphere)
    flips = (got - prod).abs()[real]
    print(f"{wire}: max |count - kernel 1| {int(flips.max())}, mean "
          f"{float(flips.double().mean()):.5f} over {int(real.sum())} atoms")
    assert int(flips.max()) <= r3_maxplus.MAX_FLIPS
    assert int(got[real].max()) > 0 or wire == "buried_lattice"


def test_fma_emulation_rounds_once():
    # a*b + c = 2^30 + 2^6 - 2^-40: f64 rounds it to the f32 midpoint
    # 2^30 + 2^6, which ties to 2^30 + 2^8; once rounded it is 2^30 + 2^7.
    a = torch.tensor([1.0 + 2.0 ** -23], dtype=torch.float32)
    b = torch.tensor([64.0 * (1.0 - 2.0 ** -23)], dtype=torch.float32)
    c = torch.tensor([2.0 ** 30 + 128.0], dtype=torch.float32)
    naive = (a.double() * b.double() + c.double()).float()
    assert float(naive) == 2.0 ** 30 + 256.0
    assert float(fma.fma_f32(a, b, c)) == 2.0 ** 30 + 128.0
    # XLA-CPU's two-term dot is the same fused multiply-add.
    lhs = np.array([[float(c), float(a)]], np.float32)
    rhs = np.array([[1.0], [float(b)]], np.float32)
    xla = jax.jit(lambda x, y: jnp.dot(x, y, precision=HI))(lhs, rhs)
    assert float(np.asarray(xla)[0, 0]) == 2.0 ** 30 + 128.0


def test_dot3_equals_xla_cpu_dots():
    rng = np.random.default_rng(5)
    s = rng.uniform(-1, 1, (104, 3)).astype(np.float32)
    c = rng.uniform(-30, 30, (3, 128)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, y: jax.lax.dot_general(
        x, y, (((1,), (0,)), ((), ())), precision=HI,
        preferred_element_type=jnp.float32))(s, c))
    st, ct = torch.from_numpy(s)[:, :, None], torch.from_numpy(c)[None]
    got = r3_maxplus.dot3(st[:, 0], ct[:, 0], st[:, 1], ct[:, 1], st[:, 2],
                          ct[:, 2])
    np.testing.assert_array_equal(got.numpy(), want)
    # The plain order differs: the emulation is what makes the port exact.
    plain = (st[:, 0] * ct[:, 0] + st[:, 1] * ct[:, 1]) + st[:, 2] * ct[:, 2]
    assert int((plain.numpy() != want).sum()) > 1000
    norms = np.asarray(jax.jit(lambda x: jnp.sum(x * x, axis=0))(c))
    ct = torch.from_numpy(c)
    np.testing.assert_array_equal(
        r3_maxplus.dot3(ct[0], ct[0], ct[1], ct[1], ct[2], ct[2]).numpy(),
        norms)


def test_device_errors_and_run_on_cpu():
    planes, jlist, _real = _lattice_wire()
    sphere = torch.from_numpy(_sphere_packed(100))
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.maxplus_count(planes, jlist, sphere)
    with pytest.raises(ValueError, match="unsupported device"):
        r3_maxplus.maxplus_counts(planes.to("meta"), jlist, sphere)
    result = r3_maxplus.run(_structures([90, 300, 500], seed=4), "cpu", w=16,
                            slots=1280, reps=1)
    assert result["tiles"] == 1 + 3 + 4 and result["build_ms"] > 0
    variants = result["variants"]
    assert list(variants) == ["prod", "mp_static"]
    assert variants["prod"]["max_dcount"] == 0
    assert variants["mp_static"]["max_dcount"] <= r3_maxplus.MAX_FLIPS
    assert variants["prod"]["margins"] == variants["mp_static"]["margins"] > 0
    assert variants["mp_static"]["instr_per_margin"] == 2
