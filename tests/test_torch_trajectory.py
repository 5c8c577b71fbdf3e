"""The port's DCD reader and streaming trajectory SASA, on the CPU.

The port's counterpart of tests/test_trajectory.py, with device="cpu",
plus two checks of `compute_trajectory_sasa` on 2drt (719 atoms, the
smallest FreeSASA structure) over 4 jittered frames: every frame equals
`calculate_sasa_internal` of the same frame byte for byte, and the
whole result agrees with the JAX package's `compute_trajectory_sasa` on
its own wire path (RUSTSASA_TPU_BACKEND=fused_interpret: the same q13
wire, the Pallas kernel in interpret mode) within the bound of the
reference's f16 readback (rustsasa_tpu/ops/engine.py:848): each atom's
area rounded to f16 is off by at most 2^-11 of itself, so a residue or
frame sum of non-negative areas is off by at most 2^-11 of the sum, plus
f32 summation slack.
"""

import gzip

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before torch runs)
import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from rustsasa_tpu.api import SASAOptions as RefOptions
from rustsasa_tpu.levels import Level as RefLevel
from rustsasa_tpu.trajectory import compute_trajectory_sasa as ref_trajectory
from rustsasa_tpu_torch import SASAOptions, calculate_sasa_internal
from rustsasa_tpu_torch.io.read import read_structure
from rustsasa_tpu_torch.levels import Level, _residue_sums
from rustsasa_tpu_torch.trajectory import (
    compute_trajectory_sasa,
    iter_frame_blocks,
    read_dcd,
    write_dcd,
)

PDB_2RES = """ATOM      1  N   ALA A   1      20.154  16.967  25.000  1.00 10.00           N
ATOM      2  CA  ALA A   1      19.030  16.155  25.000  1.00 15.00           C
ATOM      3  N   GLY A   2      17.948  16.712  25.000  1.00 20.00           N
ATOM      4  CA  GLY A   2      16.500  17.000  25.000  1.00 25.00           C
END
"""
SMALLEST = "tests/data/freesasa_pdbs/2drt.pdb.gz"
# The reference's f16 readback: relative 2^-11 per atom, hence of any sum
# of non-negative atom areas; ATOL covers f32 summation order.
F16_REL = 2.0 ** -11
ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_dcd_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    coords = rng.uniform(-50, 50, size=(5, 37, 3)).astype(np.float32)
    path = tmp_path / "t.dcd"
    write_dcd(str(path), coords)
    header, back = read_dcd(str(path))
    assert header.n_frames == 5
    assert header.n_atoms == 37
    np.testing.assert_allclose(back, coords, atol=1e-5)


def test_dcd_roundtrip_with_cell(tmp_path):
    coords = np.zeros((3, 11, 3), dtype=np.float32)
    coords[:, :, 0] = np.arange(11)[None, :]
    path = tmp_path / "c.dcd"
    write_dcd(str(path), coords, has_unit_cell=True)
    header, back = read_dcd(str(path))
    assert header.has_unit_cell
    np.testing.assert_allclose(back, coords, atol=1e-5)


def test_iter_frame_blocks(tmp_path):
    coords = np.random.default_rng(1).normal(size=(10, 8, 3)).astype(np.float32)
    path = tmp_path / "b.dcd"
    write_dcd(str(path), coords)
    seen = []
    for _, start, block in iter_frame_blocks(str(path), block=4):
        seen.append((start, block.shape[0]))
    assert seen == [(0, 4), (4, 4), (8, 2)]


def test_trajectory_sasa_matches_static(tmp_path):
    top = tmp_path / "top.pdb"
    top.write_text(PDB_2RES)

    structure = read_structure(str(top))
    opts = SASAOptions(level=Level.RESIDUE, device="cpu")
    static = opts.process(structure)

    # Frame 0 = topology coords; frame 1 = shifted apart (more SASA).
    base = structure.atoms.coords.copy()
    shifted = base.copy()
    shifted[2:, 0] += 30.0
    coords = np.stack([base, shifted])
    dcd = tmp_path / "t.dcd"
    write_dcd(str(dcd), coords)

    result = compute_trajectory_sasa(str(top), str(dcd), opts, block=8)
    assert result.n_frames == 2
    static_total = sum(r.value for r in static.residues)
    assert result.totals[0] == pytest.approx(static_total, rel=1e-4)
    assert result.totals[1] > result.totals[0]
    assert result.residue_values.shape == (2, 2)
    assert result.residue_names == ["ALA", "GLY"]


def test_trajectory_atom_count_mismatch(tmp_path):
    top = tmp_path / "top.pdb"
    top.write_text(PDB_2RES)
    dcd = tmp_path / "t.dcd"
    write_dcd(str(dcd), np.zeros((1, 7, 3), dtype=np.float32))
    with pytest.raises(ValueError, match="atoms"):
        compute_trajectory_sasa(str(top), str(dcd), device="cpu")


def test_iter_frame_blocks_streams_without_slurping(tmp_path):
    """No single read may pull more than one block of frames (+ header
    prefix); total reads ~= file size, not a multiple of it."""
    import rustsasa_tpu_torch.trajectory.dcd as dcd_mod

    coords = np.random.default_rng(2).normal(size=(64, 100, 3)).astype(
        np.float32
    )
    path = tmp_path / "big.dcd"
    write_dcd(str(path), coords)
    file_size = path.stat().st_size

    reads = []
    real_open = open

    def counting_open(p, mode="r", *a, **k):
        f = real_open(p, mode, *a, **k)
        real_read = f.read

        def read(n=-1):
            data = real_read(n)
            reads.append(len(data))
            return data

        f.read = read
        return f

    dcd_mod.open = counting_open
    try:
        blocks = list(iter_frame_blocks(str(path), block=4))
    finally:
        del dcd_mod.open

    h = blocks[0][0]
    assert h.n_frames == 64
    assert sum(b.shape[0] for _, _, b in blocks) == 64
    np.testing.assert_allclose(
        np.concatenate([b for _, _, b in blocks]), coords, atol=1e-5
    )
    # Largest single read: one 4-frame block (or the 64KB header prefix).
    block_bytes = 4 * h.frame_size
    assert max(reads) <= max(block_bytes, 65536)
    assert max(reads) < file_size
    # Every byte is read exactly once (header prefix may overlap frames).
    assert sum(reads) <= file_size + 65536


@pytest.fixture(scope="module")
def jittered(tmp_path_factory):
    """2drt decompressed, and a DCD of 4 frames of 0.3 A jitter (seed 0)."""
    tmp = tmp_path_factory.mktemp("traj")
    top = tmp / "2drt.pdb"
    with gzip.open(SMALLEST, "rb") as f:
        top.write_bytes(f.read())
    base = read_structure(str(top)).atoms.coords.astype(np.float32)
    rng = np.random.default_rng(0)
    frames = base[None] + rng.normal(0.0, 0.3, (4, *base.shape)).astype(
        np.float32)
    dcd = tmp / "t.dcd"
    write_dcd(str(dcd), frames)
    return str(top), str(dcd), frames


def test_trajectory_frames_equal_calculate_sasa_internal(jittered):
    top, dcd, frames = jittered
    opts = SASAOptions(level=Level.RESIDUE, device="cpu")
    # Two blocks of two frames: the double buffer carries one block over.
    result = compute_trajectory_sasa(top, dcd, opts, block=2)
    assert result.n_frames == 4 and result.n_atoms == frames.shape[1]
    sel = opts.build_selection(read_structure(top))
    for f in range(4):
        atom_sasa = calculate_sasa_internal(
            frames[f][sel.atom_indices], sel.radii, group_ids=sel.group_ids,
            device="cpu",
        )
        assert result.totals[f] == np.float32(float(atom_sasa.sum()))
        np.testing.assert_array_equal(result.residue_values[f],
                                      _residue_sums(sel, atom_sasa))


def test_trajectory_matches_reference(jittered, monkeypatch):
    top, dcd, _ = jittered
    got = compute_trajectory_sasa(
        top, dcd, SASAOptions(level=Level.RESIDUE, device="cpu"))
    monkeypatch.setenv("RUSTSASA_TPU_BACKEND", "fused_interpret")
    want = ref_trajectory(top, dcd, RefOptions(level=RefLevel.RESIDUE))
    assert (got.n_frames, got.n_atoms) == (want.n_frames, want.n_atoms) == (
        4, 719)
    assert got.residue_names == want.residue_names
    np.testing.assert_allclose(got.totals, want.totals,
                               rtol=F16_REL, atol=ATOL)
    np.testing.assert_allclose(got.residue_values, want.residue_values,
                               rtol=F16_REL, atol=ATOL)
