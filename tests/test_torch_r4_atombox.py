"""Parity of the port's round-4 atombox study with the reference script
`scripts/r4_atombox.py` (CPU).

The same q16 chunk (the reference's numpy packer, w = 16) goes through
the script's jitted builders and its `full` (kernel 1 in TPU interpret
mode) and through `rustsasa_tpu_torch.scripts.r4_atombox` (plain torch).
J-lists are compared byte for byte; the script's `build_only` dequantizes
inside its jit, where XLA-CPU may contract q*scale+origin into one fused
multiply-add, so its planes are held to the port's within 1 ulp at the
chunk's coordinates and the j-lists must still agree byte for byte.
Every row (the production builder's plain version, "sub32", the atombox
builder, and the production builder as the main path runs it, "kernel",
plain torch on the CPU) gives byte-equal j-lists and counts;
ATOMBOX_BLK's block sizes give the same j-lists.  Kernel 1 on atombox j-lists is held to its plain version
on the card (tests/test_torch_cuda.py).
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
from rustsasa_tpu_torch.ops import fused_kernel as port
from rustsasa_tpu_torch.scripts import _study, r4_atombox

PROBE = 1.4
W = 16
ND = 2 * W - 1
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
    """scripts/r4_atombox.py, loaded by path (it is no package module)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_r4_atombox", REPO_ROOT / "scripts" / "r4_atombox.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chunk():
    """A 7-tile q16 chunk (structures of 1, 2 and 4 tiles) on the CPU:
    (numpy wire, torch wire, dequantized planes, qvalid, offsets)."""
    rng = np.random.default_rng(21)
    structures = [
        ((rng.uniform(0, 22.0, (n, 3)) + 55.0).astype(np.float32),
         rng.choice(RADII, n), np.arange(n, dtype=np.int32))
        for n in (90, 250, 500)
    ]
    planes4, tp, tm, offsets = ref._pack_structures_q16_numpy(structures,
                                                              PROBE)
    wire = port.to_device((planes4, tp, tm), "cpu")
    planes, qvalid = port.dequant_q16(*wire[:2])
    return (planes4, tp, tm), wire, planes, qvalid, offsets


def _sphere():
    packed = _sphere_packed(100)
    s128 = np.zeros((packed.shape[0], 128), np.float32)
    s128[:, 0:4] = packed
    return torch.from_numpy(packed), s128


def test_atombox_jlist_byte_equal_script(script, chunk):
    _np_wire, wire, planes, qvalid, _ = chunk
    got = r4_atombox.build_jlist_atombox(planes, qvalid, wire[2], w=W, blk=1)
    want = np.asarray(jax.jit(
        lambda p, v, t: script.build_jlist_atombox(p, v, t, w=W)
    )(planes.numpy(), qvalid.numpy(), wire[2].numpy()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[:, 0].sum()) > 0


@pytest.mark.parametrize("fine", ["sub32", "atombox", "kernel"])
def test_build_only_byte_equal_script(script, chunk, fine):
    np_wire, wire, _planes, _qvalid, _ = chunk
    jl, planes = r4_atombox.build_only(*wire, w=W, fine=fine)
    want_jl, want_planes = script.build_only(*np_wire, w=W, fine=fine)
    np.testing.assert_array_equal(jl.numpy(), np.asarray(want_jl))
    # One ulp at the chunk's coordinates (55-77 A: 2^-17) and radii.
    np.testing.assert_allclose(planes.numpy(), np.asarray(want_planes),
                               rtol=0, atol=2.0 ** -17)


def test_rows_byte_equal_and_counts_equal_script_full(script, chunk):
    np_wire, wire, _planes, _qvalid, offsets = chunk
    packed, s128 = _sphere()
    real = _study.real_slots(offsets, wire[0].shape[1], "cpu").numpy()
    jlists, counts = {}, {}
    for fine in r4_atombox.ROWS:
        jlists[fine], _ = r4_atombox.build_only(*wire, w=W, fine=fine)
        counts[fine] = r4_atombox.full(*wire, packed, n_points=100, w=W,
                                       fine=fine).numpy()
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(script.full(*np_wire, s128, n_points=100, w=W,
                                          fine=fine))
        assert counts[fine].dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(counts[fine][real], want[real])
    a = r4_atombox.ROWS[0]
    for b in r4_atombox.ROWS[1:]:
        assert torch.equal(jlists[a], jlists[b])
        np.testing.assert_array_equal(counts[a], counts[b])
    assert ((counts[a][real] > 0) & (counts[a][real] < 100)).any()


@pytest.mark.parametrize("blk", [4, ND, 100])
def test_atombox_blocks_give_the_same_jlists(chunk, blk, monkeypatch):
    _np_wire, wire, planes, qvalid, _ = chunk
    one = r4_atombox.build_jlist_atombox(planes, qvalid, wire[2], w=W, blk=1)
    got = r4_atombox.build_jlist_atombox(planes, qvalid, wire[2], w=W,
                                         blk=blk)
    assert torch.equal(got, one)
    monkeypatch.setenv("ATOMBOX_BLK", str(blk))
    assert torch.equal(
        r4_atombox.build_jlist_atombox(planes, qvalid, wire[2], w=W), one)


def test_run_on_cpu(tmp_path):
    src = tmp_path / "corpus"
    src.mkdir()
    for name in ("2drt.pdb.gz", "2gpi.pdb.gz"):
        (src / name).symlink_to(REPO_ROOT / "tests" / "data" /
                                "freesasa_pdbs" / name)
    r = r4_atombox.run(str(src), "cpu", slots=1536, w=W, reps=1)
    assert (r["structures"], r["slots"], r["w"]) == (2, 1536, W)
    assert r["jlists_equal"] and r["counts_equal"]
    assert set(r["rows"]) == set(r4_atombox.ROWS)
    for v in r["rows"].values():
        assert v["max_dcount"] == 0 and v["streamed"] > 0
        assert v["build_ms"] > 0 and v["full_ms"] > 0
    assert len(r4_atombox.lines(r)) == 3 + len(r4_atombox.ROWS)
    with pytest.raises(ValueError, match="more than"):
        r4_atombox.run(str(src), "cpu", slots=1024, w=W, reps=1)
