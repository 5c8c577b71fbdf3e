"""Parity of the port's round-5 q12 wire study with the reference script
`scripts/r5_qwire.py` (CPU).

`pack_q12` is the script's numpy packer copied as written: its wires are
byte-equal to the script's.  The port's torch dequant is bit-equal to the
script's expressions evaluated in numpy with the multiply and the add
rounded separately (inside the script's jit XLA-CPU may fuse them), its
radii bit-equal to radii + probe, and the port's `fused_sasa_q12_banded`
counts byte-equal to the script's (Pallas kernel 1 in TPU interpret mode)
at every real slot.  Kernel 1 on q12 planes is held to its plain version
on the card (tests/test_torch_cuda.py).
"""

import importlib.util

import numpy as np
import pytest
pytest.importorskip("torch")
import torch
from jax.experimental.pallas import tpu as pltpu

from conftest import REPO_ROOT
from rustsasa_tpu.ops.engine import _sphere_packed
from rustsasa_tpu_torch.ops import fused_kernel as port
from rustsasa_tpu_torch.scripts import _study, r5_qwire

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
    """scripts/r5_qwire.py, loaded by path (it is no package module)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_r5_qwire", REPO_ROOT / "scripts" / "r5_qwire.py"
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


def _freesasa(names=("2drt.pdb.gz", "2gpi.pdb.gz")):
    return [_study.select(str(REPO_ROOT / "tests" / "data" / "freesasa_pdbs"
                              / name)) for name in names]


def _sphere():
    packed = _sphere_packed(100)
    s128 = np.zeros((packed.shape[0], 128), np.float32)
    s128[:, 0:4] = packed
    return torch.from_numpy(packed), s128


@pytest.mark.parametrize("source", ["random", "freesasa"])
def test_pack_q12_byte_equal_script(script, source):
    structures = (_structures([100, 300, 700], seed=1) if source == "random"
                  else _freesasa())
    got = r5_qwire.pack_q12(structures, PROBE)
    want = script.pack_q12(structures, PROBE)
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for (gp, gn, gi), (wp, wn, wi) in zip(got[5], want[5]):
        assert (gp, gn) == (wp, wn)
        np.testing.assert_array_equal(gi, wi)
    # Over the 100 A extent: no q12 wire, on both sides.
    far = _structures([50], seed=2, spread=150.0)
    assert r5_qwire.pack_q12(far, PROBE) is None
    assert script.pack_q12(far, PROBE) is None


def test_dequant_bit_equal_numpy_spec():
    structures = _structures([100, 300, 700], seed=3)
    wa, wb, pal, tp, tm, offsets = r5_qwire.pack_q12(structures, PROBE)
    planes, qvalid = r5_qwire.dequant_q12(
        *port.to_device((wa, wb, pal, tp), "cpu"))
    wa64, wb64 = wa.astype(np.uint32), wb.astype(np.uint32)
    q = np.stack([
        wa64 & 0xFFF,
        (wa64 >> 12) & 0xFFF,
        ((wa64 >> 24) & 0xFF) << 4 | (wb64 & 0xF),
    ]).astype(np.float32)
    ridx = (wb64 >> 4) & 0xFF
    par = np.repeat(tp, 128, axis=0)
    want = np.zeros((port.N_PLANES, wa.shape[0]), np.float32)
    for axis in range(3):
        want[axis] = q[axis] * par[:, 3] + par[:, axis]
    want[3] = pal[ridx]
    want[4] = np.where(ridx > 0, np.arange(wa.shape[0], dtype=np.float32) + 1,
                       0)
    np.testing.assert_array_equal(planes.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(qvalid.numpy(), ridx > 0)
    assert r5_qwire.r_eff_exact((wa, wb, pal, tp, tm), offsets, structures,
                                PROBE, "cpu")


@pytest.mark.parametrize("source", ["random", "freesasa"])
def test_counts_byte_equal_script(script, source):
    structures = (_structures([100, 300, 700], seed=4) if source == "random"
                  else _freesasa())
    wire = r5_qwire.pack_q12(structures, PROBE)
    *wire, offsets = wire
    packed, s128 = _sphere()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(script.fused_sasa_q12_banded(
            *wire, s128, n_points=100, w=16))
    got = r5_qwire.fused_sasa_q12_banded(
        *port.to_device(wire, "cpu"), packed, n_points=100, w=16).numpy()
    real = _study.real_slots(offsets, got.shape[0], "cpu").numpy()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got[real], want[real])
    assert ((got[real] > 0) & (got[real] < 100)).any()


def test_run_on_cpu(tmp_path):
    src = tmp_path / "corpus"
    src.mkdir()
    for name in ("2drt.pdb.gz", "2gpi.pdb.gz"):
        (src / name).symlink_to(REPO_ROOT / "tests" / "data" /
                                "freesasa_pdbs" / name)
    r = r5_qwire.run(str(src), "cpu", slots=1536, w=16, reps=1)
    assert (r["structures"], r["slots"]) == (2, 1536)
    assert r["r_eff_exact"] and r["palette"] > 1
    assert set(r["routes"]) == {"q16", "q12"}
    assert 0 <= r["n_diff"] <= r["atoms"] and r["max_dcount"] >= 0
    assert all(v["ms"] > 0 for v in r["routes"].values())
    assert len(r5_qwire.lines(r)) == 6
