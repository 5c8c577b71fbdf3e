"""A run with the timed path broken underneath comes out not correct.

Each fault is planted where the program's answers are produced, at the
readback of a chunk's counts (`ops.engine._Readback.numpy`), which every
cell's answers pass through: the trajectory's residue sums, the native
JSON emit and the library's per-atom arrays.  The chunk budget is cut so
that a tiny pass holds several chunks.
"""

from __future__ import annotations

import numpy as np
import pytest

from .conftest import CELLS


def _altered(out, state):
    """An answer altered where it is produced: every 7th count zeroed."""
    out = out.copy()
    out[::7] = 0
    return out


def _half_mean(out, state):
    """Half of the batch left out, the mean of the rest in its place."""
    out = out.copy()
    h = len(out) // 2
    out[h:] = out[:h].astype(np.float64).mean().astype(out.dtype)
    return out


def _stale(out, state):
    """A step that returns its state unchanged: each chunk's readback
    holds the previous chunk's counts (cut or repeated to its length)."""
    prev = state.get("prev")
    state["prev"] = out
    return out if prev is None else np.resize(prev, out.shape)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_altered, _half_mean, _stale])
def test_fault_is_not_correct(tiny_run, monkeypatch, cell, fault):
    from rustsasa_tpu_torch.ops import engine

    plain = engine._Readback.numpy
    state = {}

    def broken(self):
        return fault(plain(self), state)

    monkeypatch.setattr(engine._Readback, "numpy", broken)
    monkeypatch.setattr(engine, "CHUNK_SLOT_BUDGET", 2048)
    rc, result = tiny_run(cell)
    assert rc == 0 and result is not None
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_chunk_budget_cut_alone_stays_correct(tiny_run, monkeypatch, cell):
    from rustsasa_tpu_torch.ops import engine

    monkeypatch.setattr(engine, "CHUNK_SLOT_BUDGET", 2048)
    rc, result = tiny_run(cell)
    assert rc == 0 and result["correct"] is True, result["checks"]
