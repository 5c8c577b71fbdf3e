"""Backpressure of the port's directory batch (CPU): corpora of tiny files
larger than the permit cap.

The port's `batch.py` is a copy of the reference's, so its two cases
(tests/test_batch_backpressure.py) run here against
`rustsasa_tpu_torch.batch` with the plain-torch kernels: a corpus five
times the (shrunken) backlog cap of minimum-size files must complete, and
files that fail must release their permits.
"""

import pytest
pytest.importorskip("torch")
import torch

import rustsasa_tpu_torch.batch as batch
from rustsasa_tpu_torch.api import SASAOptions
from rustsasa_tpu_torch.levels import Level

_TINY_PDB = """\
ATOM      1  N   ALA A   1      11.104   6.134  -6.504  1.00  0.00           N
ATOM      2  CA  ALA A   1      11.639   6.071  -5.147  1.00  0.00           C
ATOM      3  C   ALA A   1      12.697   7.169  -5.000  1.00  0.00           C
ATOM      4  O   ALA A   1      13.560   7.171  -4.113  1.00  0.00           O
ATOM      5  CB  ALA A   1      12.260   4.711  -4.913  1.00  0.00           C
END
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_small_file_corpus_exceeding_backlog_cap(tmp_path, monkeypatch):
    monkeypatch.setattr(batch, "_BACKLOG_CAP", 4)
    monkeypatch.setattr(batch, "_STALL_POLL_S", 0.05)

    in_dir = tmp_path / "in"
    out_dir = tmp_path / "out"
    in_dir.mkdir()
    n_files = 20
    for i in range(n_files):
        (in_dir / f"tiny_{i:03d}.pdb").write_text(_TINY_PDB)

    report = batch.process_directory(
        str(in_dir), str(out_dir),
        SASAOptions(level=Level.RESIDUE, device="cpu"), "json",
        progress=False, workers=4,
    )
    assert report.n_files == n_files
    assert report.n_ok == n_files
    assert report.errors == []
    outs = sorted(out_dir.iterdir())
    assert len(outs) == n_files
    # All files identical -> all outputs identical and nonzero.
    texts = {p.read_text() for p in outs}
    assert len(texts) == 1
    assert report.total_area > 0.0


def test_error_files_release_permits(tmp_path, monkeypatch):
    """Per-file errors must release their permit (no emit runs for them)."""
    monkeypatch.setattr(batch, "_BACKLOG_CAP", 3)
    monkeypatch.setattr(batch, "_STALL_POLL_S", 0.05)

    in_dir = tmp_path / "in"
    out_dir = tmp_path / "out"
    in_dir.mkdir()
    for i in range(6):
        (in_dir / f"tiny_{i:03d}.pdb").write_text(_TINY_PDB)
    for i in range(6):
        (in_dir / f"bad_{i:03d}.pdb").write_text("garbage that is not a pdb\n")

    report = batch.process_directory(
        str(in_dir), str(out_dir),
        SASAOptions(level=Level.RESIDUE, device="cpu"), "json",
        progress=False, workers=3,
    )
    assert report.n_files == 12
    assert report.n_ok == 6
    assert len(report.errors) == 6
