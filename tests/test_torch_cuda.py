"""The port's CUDA kernel against its plain-torch version, on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rustsasa_tpu_torch.ops import _kernels, engine
from rustsasa_tpu_torch.ops import fused_kernel as fk

pytestmark = pytest.mark.gpu

RADII = np.array([1.4, 1.55, 1.6, 1.7, 1.8, 1.9, 2.0], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _structures(sizes, seed, spread=30.0):
    rng = np.random.default_rng(seed)
    return [
        ((rng.uniform(0, spread, (n, 3)) + 50.0).astype(np.float32),
         rng.choice(RADII, n), np.arange(n, dtype=np.int32))
        for n in sizes
    ]


# n_points 20/60/100/256/1000 exercise one and several point passes and
# per-thread point counts K of 6, 16, 13, 16 and 16.
@pytest.mark.parametrize("n_points", [20, 60, 100, 256, 1000])
def test_kernel_byte_equal_plain(cuda, n_points):
    structures = _structures([100, 700, 2600, 3700], seed=n_points)
    structures[0][0][1] = structures[0][0][0]  # coincident atoms
    wa, wb, pal, tp, tm, offsets = fk.pack_structures_q13(structures, 1.4)
    wire = fk.to_device((wa, wb, pal, tp, tm), cuda)
    planes, qvalid = fk.dequant_q13(*wire[:4])
    jlist = fk.build_jlist_banded(planes, qvalid, wire[4], w=32)
    sphere = engine._sphere_device(n_points, cuda)
    before = _kernels.launch_counts["fused_count"]
    got = fk.fused_counts(planes, jlist, sphere)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["fused_count"] == before + 1
    want = fk.fused_counts_reference(planes, jlist, sphere)
    real = torch.zeros(wa.shape[0], dtype=torch.bool, device=cuda)
    for pos, n, _inv in offsets:
        real[pos:pos + n] = True
    assert torch.equal(got[real], want[real])
    assert int(got[real].max()) <= n_points


def test_engine_cuda_equals_cpu(cuda):
    structures = _structures([90, 400, 1300], seed=5)
    structures.append(_structures([260], seed=6, spread=120.0)[0])  # q16
    eng = engine.BatchedSasaEngine(device=cuda)
    _kernels.reset_launch_counts()
    got = eng.compute(structures)
    assert _kernels.launch_counts["fused_count"] == eng.chunks_dispatched == 2
    want = engine.BatchedSasaEngine(device="cpu").compute(structures)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_kernel_wrapper_checks_inputs(cuda):
    planes = torch.zeros((8, 256), device=cuda)
    sphere = torch.zeros((104, 4), device=cuda)
    with pytest.raises(ValueError, match="jlist shape"):
        _kernels.fused_count(planes, torch.zeros((1, 128), dtype=torch.int32,
                                                 device=cuda), sphere)
    with pytest.raises(TypeError):
        _kernels.fused_count(planes, torch.zeros((2, 128), device=cuda),
                             sphere)
