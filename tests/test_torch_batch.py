"""The PyTorch port's directory batch against the JAX pipeline (CPU).

Both packages run the reference's own `process_directory` (the port through
its `_host` alias) over the same files, one after the other: the native
radius table is process-global state.  Output files must be byte-identical.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import REFERENCE_DATA
from rustsasa_tpu.api import SASAOptions as RefOptions
from rustsasa_tpu.batch import process_directory as ref_process_directory
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

SMALL_PDBS = ("2drt.pdb.gz", "2gpi.pdb.gz", "3uc7.pdb.gz")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    shutil.copy(REFERENCE_DATA / "pdbs" / "example.cif", d / "example.cif")
    for name in SMALL_PDBS:
        shutil.copy(REFERENCE_DATA / "freesasa_pdbs" / name, d / name)
    return d


def _outputs(out_dir):
    return {
        f: (out_dir / f).read_bytes() for f in sorted(os.listdir(out_dir))
    }


@pytest.mark.parametrize("fmt", ["json", "xml"])
def test_process_directory_byte_identical_to_reference(corpus, tmp_path, fmt):
    ref_out = tmp_path / "ref"
    ref_report = ref_process_directory(
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
