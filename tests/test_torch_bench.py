"""The port's benches on the CPU, at a tiny size: the corpus rule, the
record of `python -m rustsasa_tpu_torch.bench`, the MD-trajectory bench
and the single-protein bench.  Times from these runs are the CPU's and
are only checked for shape."""

import gzip
import json
import os
import shutil

import pytest
pytest.importorskip("torch")
import torch

from conftest import REPO_ROOT
from rustsasa_tpu_torch import bench
from rustsasa_tpu_torch.benches import md_trajectory, single_protein

PDB_DIR = REPO_ROOT / "tests" / "data" / "freesasa_pdbs"
SMALLEST = ("2drt.pdb.gz", "2gpi.pdb.gz", "3uc7.pdb.gz")  # 719-1,049 atoms


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def source(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in SMALLEST:
        shutil.copy(PDB_DIR / name, src / name)
    return src


@pytest.fixture()
def tiny_corpus(source, monkeypatch):
    """The bench's corpus rule on the three smallest structures: a target
    mean of 790 atoms takes 2drt (719) and 2gpi (861), and 4 files hold
    3,160 atoms."""
    monkeypatch.setattr(bench, "SOURCE_DIR", str(source))
    monkeypatch.setattr(bench, "TARGET_FILES", 4)
    monkeypatch.setattr(bench, "TARGET_ATOMS", 3160)
    return source


def test_build_corpus_rule(tiny_corpus, tmp_path, monkeypatch):
    corpus = tmp_path / "corpus"
    files, atoms, distinct = bench.build_corpus(str(corpus))
    assert (files, atoms, distinct) == (4, 3160, 2)
    names = sorted(os.listdir(corpus))
    assert names == ["2drt_00000.pdb.gz", "2drt_00002.pdb.gz",
                     "2gpi_00001.pdb.gz", "2gpi_00003.pdb.gz"]
    assert os.path.realpath(corpus / names[0]) == str(
        tiny_corpus / SMALLEST[0])
    # Both targets must be met: one atom more takes a fifth file.
    monkeypatch.setattr(bench, "TARGET_ATOMS", 3161)
    assert bench.build_corpus(str(corpus))[:2] == (5, 3160 + 719)


def test_bench_record(tiny_corpus, tmp_path, monkeypatch):
    from rustsasa_tpu_torch.scripts import quality_gate

    # The gate's 88 files take over an hour on the CPU: stand in a row.
    gate = {"pass": True, "rmse": 45.0, "rows": [{
        "depth": "residue", "rmse": 45.0, "n": 3, "n_ok": 2, "n_files": 2,
        "pass": True}]}
    written = []
    monkeypatch.setattr(quality_gate, "run_gate", lambda device: gate)
    monkeypatch.setattr(quality_gate, "write_artifact", written.append)
    record = bench.run("cpu", str(tmp_path / "work"), say=lambda msg: None)
    json.dumps(record)
    assert written == [gate]
    assert len(record["passes"]) == bench.PASSES == 5
    assert record["runs"] == sorted(record["passes"])
    assert record["median"] == record["value"] == record["runs"][2]
    assert record["spread"] == pytest.approx(
        (record["runs"][-1] - record["runs"][0]) / record["median"])
    assert record["vs_baseline"] == pytest.approx(
        bench.BASELINE_SECONDS / record["median"])
    assert record["n_ok"] == [record["n_files"]] * 5 == [4] * 5
    assert record["n_errors"] == 0
    # The count kernel launches only on CUDA; the chunks are counted.
    assert record["fused_count_launches"] == [0] * 5
    assert record["chunks"] == [1] * 5
    assert record["band_launches"] == [
        {"dequant_boxes": 0, "band_jlist": 0}] * 5
    assert [r["q13"] for r in record["routes"]] == [1] * 5
    assert record["entries"] == [[1]] * 5  # one device entry: the CPU
    assert (record["package"], record["backend"], record["device"]) == (
        "rustsasa_tpu_torch", "fused", "cpu")
    assert record["gpu_name"] is None and record["power_limit"] is None
    assert (record["quality_pass"], record["quality_residue_rmse"]) == (
        True, 45.0)
    assert record["build_s"] == 0.0
    assert record["warm_shapes_s"] == 0.0  # no card: nothing to warm
    assert sorted(os.listdir(tmp_path / "work" / "out")) == [
        "2drt_00000.json", "2drt_00002.json", "2gpi_00001.json",
        "2gpi_00003.json"]


def test_md_trajectory_bench(source):
    top = str(source / "2drt.pdb")
    with gzip.open(source / "2drt.pdb.gz", "rb") as f:
        (source / "2drt.pdb").write_bytes(f.read())
    record = md_trajectory.run(top, 3, "cpu", say=lambda msg: None)
    result = record.pop("result")
    json.dumps(record)
    assert result.n_frames == record["frames"] == 3
    assert result.residue_values.shape[0] == 3
    assert record["atoms_per_frame"] == 719
    assert record["ms_per_frame"] == pytest.approx(record["value"] / 3 * 1e3)


def test_single_protein_bench(capsys, monkeypatch):
    monkeypatch.setattr(single_protein, "REPS", 1)
    record = single_protein.run(str(PDB_DIR / "2drt.pdb.gz"), "cpu")
    json.dumps(record)
    assert set(record["stages_median_ms"]) == {
        "parse_select", "device", "emit", "total", "cli_main", "floor"}
    assert record["value"] == record["stages_median_ms"]["total"]
    assert "single-protein latency" in capsys.readouterr().err
