"""The control (the reference in bfloat16 in the program's place) fails
each cell's limits, at a size a test run holds; on the card and at the
cells' own sizes `python3 -m benchmark.control` reads it (PERF.md)."""

from __future__ import annotations

import pytest

from benchmark import control

from .conftest import CELLS, tiny_spec


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tmp_path, cell):
    spec = tiny_spec(cell)
    got = control.readings(cell, 2147483911, program=True, device="cpu",
                           spec=spec, workdir=str(tmp_path))
    limits = spec["limits"]
    failed = [n for n, lim in limits.items() if got["control"][n] > lim]
    assert failed, got
    assert all(got["program"][n] <= lim for n, lim in limits.items()), got
