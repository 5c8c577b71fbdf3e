"""The port's multi-process directory batch: two real processes on Gloo
(CPU), after tests/test_distributed.py.

Two `rustsasa_tpu_torch.parallel.worker` processes (started by its
`run_workers`) join one Gloo group,
shard a small corpus round-robin, run their shards through the batch
pipeline on the CPU and all-reduce the run metrics.  Both must report
the same global totals, every input must be written exactly once, and
the outputs must be the bytes a one-process run of the port writes.
"""

import os
import shutil

import pytest
pytest.importorskip("torch")
import torch

from conftest import REPO_ROOT
from rustsasa_tpu_torch.parallel.worker import run_workers

NAMES = ("example.cif", "bad_seqadv_1A06.pdb", "151L_H3.pdb")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    env.pop("MASTER_PORT", None)
    return env


def test_two_workers_on_gloo_match_one_process(reference_data_dir,
                                               tmp_path):
    from rustsasa_tpu_torch import (BatchedSasaEngine, Level, SASAOptions,
                                    SasaParams, process_directory)

    input_dir = tmp_path / "in"
    input_dir.mkdir()
    for name in NAMES:
        shutil.copy(reference_data_dir / "pdbs" / name, input_dir / name)

    out_dir = tmp_path / "out"
    got, _wall = run_workers(2, str(input_dir), str(out_dir),
                             str(tmp_path / "reports"), device="cpu",
                             timeout=300, env=_env())
    assert [r["rank"] for r in got] == [0, 1]
    for r in got:
        assert r["world_size"] == 2 and r["device"] == "cpu"
        # Its own shard, then the wait at the final all-reduce.
        assert 0.0 < r["shard_s"] <= r["elapsed_s"]
    shared = ("n_files", "n_ok", "n_errors", "total_area")
    assert [got[0][k] for k in shared] == [got[1][k] for k in shared]
    assert got[0]["n_files"] == got[0]["n_ok"] == len(NAMES)
    assert got[0]["n_errors"] == 0 and got[0]["total_area"] > 0.0
    # The CPU runs the plain versions: no kernel launches.
    assert not any(sum(r["launches"].values()) for r in got)

    produced = sorted(os.listdir(out_dir))
    assert produced == sorted(os.path.splitext(n)[0] + ".json"
                              for n in NAMES)
    one_dir = tmp_path / "one"
    one = process_directory(
        str(input_dir), str(one_dir), SASAOptions(level=Level.RESIDUE),
        "json", progress=False,
        engine=BatchedSasaEngine(SasaParams(), device="cpu"))
    assert one.n_ok == len(NAMES)
    for name in produced:
        assert (out_dir / name).read_bytes() == (one_dir / name).read_bytes()
    # The two-float split reduces to the one-process total within f32
    # rounding of each rank's part.
    assert got[0]["total_area"] == pytest.approx(one.total_area, rel=1e-6)


def test_worker_asked_for_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    (tmp_path / "in").mkdir()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_workers(1, str(tmp_path / "in"), str(tmp_path / "out"),
                    str(tmp_path / "reports"), timeout=120, env=_env())
    assert not list((tmp_path / "reports").iterdir())
