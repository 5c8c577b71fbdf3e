"""Shared tiny cells for the benchmark's own tests (run on the CPU with
`python -m pytest benchmark/tests -q`; the card's test with `-m gpu`)."""

from __future__ import annotations

import json

import pytest

from benchmark import run

TINY_STRUCTURES = ["2drt.pdb.gz", "2gpi.pdb.gz", "3uc7.pdb.gz"]
CELLS = ["md960.traj", "proteome.dir", "proteome.lib"]

# The proteome cells are measured but not in BENCHMARK.json (PERF.md,
# Open questions): their configuration, mixes, limits and runners stay
# for the change that lists them, and the tests drive them through these
# entries as the manifest would.
UNLISTED = {
    "configs": [{"name": "ecoli_afdb_p100",
                 "file": "benchmark/configs/ecoli_afdb_p100.json"}],
    "workloads": [
        {"name": "proteome.dir", "config": "ecoli_afdb_p100",
         "traffic": "directory_passes", "chips": 1},
        {"name": "proteome.lib", "config": "ecoli_afdb_p100",
         "traffic": "library_passes", "chips": 1},
    ],
}


def manifest() -> dict:
    """BENCHMARK.json with the unlisted cells' entries."""
    with open(run.MANIFEST, encoding="utf-8") as f:
        out = json.load(f)
    for key, entries in UNLISTED.items():
        out[key] = out[key] + entries
    return out


def tiny_spec(cell: str) -> dict:
    """The cell's spec cut to a size the CPU's plain kernels run in
    seconds: the cell's topology over 2 frames in blocks of 1, or 3
    structures cycled to 10 copies; the sphere as configured."""
    spec = run.cell_spec(cell, manifest())
    if cell.startswith("md"):
        spec["config"].update(n_frames=2)
        spec["traffic"].update(block=1, checked_frames=2)
    else:
        spec["config"].update(structures=TINY_STRUCTURES, target_files=9,
                              target_atoms=8000)
    return spec


@pytest.fixture
def tiny_run(tmp_path, capsys):
    """Run a tiny cell on the CPU through run.main; returns (rc, result
    dict or None)."""

    def go(cell, seed=12345678901, trace=0):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       "0.2", "--trace", str(trace)], device="cpu",
                      require_card=False, spec=tiny_spec(cell),
                      workdir=str(tmp_path / cell))
        out = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(out[-1]) if out else None)

    return go
