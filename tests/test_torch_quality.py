"""The port's FreeSASA quality report and gate, on the CPU.

`scripts/quality_report.py` of the port against the JAX package's
(scripts/quality_report.py), and the port's 88-file gate.  The reference
runs on its own wire path (RUSTSASA_TPU_BACKEND=fused_interpret: the
same q13 wire, the Pallas kernel in interpret mode).  Its engine reads
areas back as f16 (rustsasa_tpu/ops/engine.py:848): each atom's area off
by at most 2^-11 of itself, so each chain total k by at most 2^-11 of
ours_k.  The RMSE over n chains then moves by at most the largest such
change, and ours_k <= FreeSASA_k + sqrt(n) * rmse.
"""

import gzip
import json
import math
import os
import shutil
import sys

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before torch runs)
import pytest
pytest.importorskip("torch")
import torch

from conftest import REPO_ROOT
from rustsasa_tpu_torch.scripts import quality_gate, quality_report

sys.path.insert(0, str(REPO_ROOT / "scripts"))
import quality_report as ref_quality_report  # noqa: E402

PDB_DIR = REPO_ROOT / "tests" / "data" / "freesasa_pdbs"
REF_DIR = REPO_ROOT / "tests" / "data" / "freesasa_reference"
# The three smallest FreeSASA structures (719, 861 and 1,049 atoms).
SMALLEST = ("2drt.pdb.gz", "2gpi.pdb.gz", "3uc7.pdb.gz")
F16_REL = 2.0 ** -11
ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _freesasa_chain_totals(names):
    totals = []
    for name in names:
        with open(REF_DIR / (name.split(".")[0] + ".json")) as f:
            data = json.load(f)
        totals += [chain["area"]["total"] for result in data["results"]
                   for structure in result["structure"]
                   for chain in structure["chains"]]
    return totals


def test_evaluate_depth_matches_reference(tmp_path, monkeypatch):
    src = tmp_path / "pdbs"
    src.mkdir()
    for name in SMALLEST:
        shutil.copy(PDB_DIR / name, src / name)
    got = quality_report.evaluate_depth("residue", str(src), str(REF_DIR),
                                        device="cpu")
    monkeypatch.setenv("RUSTSASA_TPU_BACKEND", "fused_interpret")
    want = ref_quality_report.evaluate_depth("residue", str(src),
                                             str(REF_DIR))
    for key in ("depth", "n", "n_files", "n_ok", "errors"):
        assert got[key] == want[key], key
    assert got["n_ok"] == got["n_files"] == 3 and got["n"] >= 3
    largest = max(_freesasa_chain_totals(SMALLEST))
    bound = F16_REL * (largest + math.sqrt(got["n"]) * got["rmse"]) + ATOL
    assert abs(got["rmse"] - want["rmse"]) <= bound
    assert got["pearson_r"] == pytest.approx(want["pearson_r"], abs=ATOL)


@pytest.mark.parametrize("name", SMALLEST + ("1jz8.pdb.gz",))
def test_rewrite_occupancy_matches_reference(name):
    with gzip.open(PDB_DIR / name, "rt") as f:
        text = f.read()
    got = quality_report.rewrite_occupancy_with_radii(text)
    assert got == ref_quality_report.rewrite_occupancy_with_radii(text)
    assert got != text


@pytest.mark.parametrize("atom_name", [" CA ", "CA  ", "FE  ", " N1 ",
                                       "1HB ", "ZN  ", "    "])
def test_guess_element_matches_reference(atom_name):
    assert quality_report.guess_element(atom_name) == \
        ref_quality_report.guess_element(atom_name)


def test_gate_row_rules():
    row = quality_gate._row({
        "depth": "residue", "n": 2, "rmse": float("inf"),
        "pearson_r": float("nan"), "n_files": 2, "n_ok": 2, "errors": [],
    })
    assert (row["rmse"], row["pearson_r"], row["pass"]) == (1e30, 0.0, False)
    row = quality_gate._row({
        "depth": "chain", "n": 2, "rmse": quality_gate.RMSE_LIMIT,
        "pearson_r": 0.99, "n_files": 2, "n_ok": 1, "errors": ["x"],
    })
    assert row["pass"] is False and row["errors"] == ["x"]
    assert quality_gate.RMSE_LIMIT == pytest.approx(63.99)
    assert os.path.relpath(quality_gate.DEFAULT_OUT, REPO_ROOT) == os.path.join(
        "build", "rustsasa_tpu_torch", "quality_latest.json")


@pytest.mark.slow
def test_quality_gate_all_depths(tmp_path):
    out = tmp_path / "quality.json"
    assert quality_gate.main(["--device", "cpu", "--out", str(out)]) == 0
    result = json.loads(out.read_text())
    assert [row["depth"] for row in result["rows"]] == [
        "residue", "atom", "chain", "protein", "occupancy_residue"]
    for row in result["rows"]:
        assert row["pass"] and row["n_ok"] == row["n_files"] == 88, row
    assert result["pass"] and result["platform"] == "cpu"
