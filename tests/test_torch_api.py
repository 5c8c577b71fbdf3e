"""The port's builder API (`SASAOptions`) against the JAX package's (CPU).

`SASAOptions(device="cpu").process` runs the port's engine with its
plain-torch kernels on the q13 wire.  The reference's `process` on the
CPU takes its unquantized XLA path by default, which lies up to 4.06 A^2
from the wire path at one atom of example.cif (three boundary points)
and 14.85 A^2 from it in the protein total; so the reference runs here
on its own wire path (RUSTSASA_TPU_BACKEND=fused_interpret: the same
q13 wire, the Pallas kernel in interpret mode), and every level is held
to tests/test_pallas.py's tolerance for identical planes (atol 1e-3).
"""

import dataclasses
import os

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before torch runs)
import numpy as np
import pytest
import torch

from rustsasa_tpu import SASAOptions as RefOptions
from rustsasa_tpu import read_structure as ref_read_structure
from rustsasa_tpu.levels import Level as RefLevel
from rustsasa_tpu_torch import (
    BatchedSasaEngine, Level, SASAOptions, SasaParams, process_directory,
    read_structure,
)

EXAMPLE = "tests/data/pdbs/example.cif"
ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and each process's spinning OpenMP threads would fight the
    others' for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def structures():
    return read_structure(EXAMPLE), ref_read_structure(EXAMPLE)


@pytest.mark.parametrize("level", ["ATOM", "RESIDUE", "CHAIN", "PROTEIN"])
def test_process_on_cpu_matches_reference(structures, level, monkeypatch):
    port_s, ref_s = structures
    monkeypatch.setenv("RUSTSASA_TPU_BACKEND", "fused_interpret")
    got = SASAOptions(level=Level[level], device="cpu").process(port_s)
    want = RefOptions(level=RefLevel[level]).process(ref_s)
    assert got.level.name == level
    if level == "ATOM":
        assert got.atoms.shape == want.atoms.shape
        np.testing.assert_allclose(got.atoms, want.atoms, atol=ATOL, rtol=0)
    elif level == "RESIDUE":
        assert [(r.serial_number, r.insertion_code, r.name, r.chain_id,
                 r.is_polar) for r in got.residues] == [
            (r.serial_number, r.insertion_code, r.name, r.chain_id, r.is_polar)
            for r in want.residues]
        np.testing.assert_allclose([r.value for r in got.residues],
                                   [r.value for r in want.residues],
                                   atol=ATOL, rtol=0)
    elif level == "CHAIN":
        assert [c.name for c in got.chains] == [c.name for c in want.chains]
        np.testing.assert_allclose([c.value for c in got.chains],
                                   [c.value for c in want.chains],
                                   atol=ATOL, rtol=0)
    else:
        for field in ("global_total", "polar_total", "non_polar_total"):
            assert getattr(got.protein, field) == pytest.approx(
                getattr(want.protein, field), abs=ATOL), field


def test_device_defaults_to_cuda_and_never_falls_back(structures, monkeypatch):
    opts = SASAOptions()
    assert opts.device == "cuda"
    assert opts.with_device("cpu").device == "cpu"
    assert dataclasses.replace(opts, device="cpu") == opts.with_device("cpu")
    # Without CUDA, asking for it raises instead of running on the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        opts.process(structures[0])


def test_process_directory_builds_its_engine_on_options_device(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    (src / "2drt.pdb.gz").symlink_to(
        os.path.abspath("tests/data/freesasa_pdbs/2drt.pdb.gz"))
    outs = []
    for engine in (None, BatchedSasaEngine(SasaParams(), device="cpu")):
        out = tmp_path / f"out_{len(outs)}"
        rep = process_directory(str(src), str(out),
                                SASAOptions(device="cpu"), "json",
                                progress=False, engine=engine)
        assert rep.n_ok == rep.n_files == 1 and not rep.errors
        outs.append((out / "2drt.json").read_bytes())
    assert outs[0] == outs[1]
