"""The PyTorch port's directory batch against the JAX pipeline (CPU).

Both packages run their own `process_directory` (the port's is a copy of
the reference's, on its own native library) over the same files, one
after the other.  Output files must be byte-identical, on the native C++
host route and on the Python one, and both sides must take the same
route.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustsasa_tpu.batch as ref_batch
import rustsasa_tpu.native as ref_native
import rustsasa_tpu_torch.batch as port_batch
import rustsasa_tpu_torch.native as port_native
from conftest import REFERENCE_DATA
from rustsasa_tpu.api import SASAOptions as RefOptions
from rustsasa_tpu.levels import Level as RefLevel
from rustsasa_tpu.ops.engine import BatchedSasaEngine as RefEngine
from rustsasa_tpu.ops.engine import SasaParams as RefParams
from rustsasa_tpu_torch import (
    BatchedSasaEngine,
    Level,
    SASAOptions,
    SasaParams,
    process_directory,
)
from rustsasa_tpu_torch._host_build import build_shared_library

SMALL_PDBS = ("2drt.pdb.gz", "2gpi.pdb.gz", "3uc7.pdb.gz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and each process's spinning OpenMP threads would fight the
    others' for the same cores (a 1 s test took 300 s that way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    shutil.copy(REFERENCE_DATA / "pdbs" / "example.cif", d / "example.cif")
    for name in SMALL_PDBS:
        shutil.copy(REFERENCE_DATA / "freesasa_pdbs" / name, d / name)
    return d


@pytest.fixture(scope="module", autouse=True)
def native_library_on_both_sides():
    """Both packages load the complete native library.

    A fresh checkout builds it on first use; the reference's loader
    builds in place, so in a run with several workers one may load a
    half-written file and latch `_lib_failed` for the rest of its life.
    The locked build below leaves a complete file; a latch left by such a
    race is cleared for this module, so the two sides cannot silently
    take different host routes.
    """
    path = build_shared_library(
        ref_native._SRC, ref_native._LIB, ref_native._build
    )
    assert path is not None, "the native library does not build here"
    with pytest.MonkeyPatch.context() as mp:
        if ref_native._lib is None and ref_native._lib_failed:
            mp.setattr(ref_native, "_lib_failed", False)
        assert ref_native.pipe_library() is not None, "JAX side: no native lib"
        assert port_native.pipe_library() is not None, "port: no native lib"
        yield


def _outputs(out_dir):
    return {
        f: (out_dir / f).read_bytes() for f in sorted(os.listdir(out_dir))
    }


@pytest.mark.parametrize("fmt, route", [
    pytest.param("json", "native", id="json"),
    pytest.param("xml", "native", id="xml"),
    pytest.param("json", "python", id="json-python"),
    pytest.param("xml", "python", id="xml-python"),
])
def test_process_directory_byte_identical_to_reference(
    corpus, tmp_path, monkeypatch, fmt, route
):
    if route == "python":
        # Force the Python host spine on both sides, as
        # tests/test_native_pipe.py does for the reference.
        monkeypatch.setattr(ref_batch, "pipe_library", lambda: None)
        monkeypatch.setattr(port_batch, "pipe_library", lambda: None)
    ref_out = tmp_path / "ref"
    ref_report = ref_batch.process_directory(
        str(corpus), str(ref_out), RefOptions(level=RefLevel.RESIDUE), fmt,
        progress=False, workers=2,
        engine=RefEngine(RefParams(), backend="fused_interpret",
                         readback_dtype=jnp.float32),
    )
    port_out = tmp_path / "port"
    report = process_directory(
        str(corpus), str(port_out), SASAOptions(level=Level.RESIDUE), fmt,
        progress=False, workers=2,
        engine=BatchedSasaEngine(SasaParams(), device="cpu"),
    )
    assert report.errors == ref_report.errors == []
    assert report.n_ok == ref_report.n_ok == 1 + len(SMALL_PDBS)
    np.testing.assert_allclose(report.total_area, ref_report.total_area,
                               rtol=0, atol=0)
    want = _outputs(ref_out)
    got = _outputs(port_out)
    assert list(got) == list(want) and len(got) == 1 + len(SMALL_PDBS)
    for name in want:
        assert got[name] == want[name], name
