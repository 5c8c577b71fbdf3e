"""Parity of the port's round-4 saturation study with the reference script
`scripts/r4_saturation.py` (CPU).

The same host-cull f32 wires (the reference's numpy packer, and a buried
lattice block on which the skip fires) go through the script's Pallas
kernel in TPU interpret mode (`run_variant_counts`: f16 counts, exact up
to 2,048) and through `rustsasa_tpu_torch.scripts.r4_saturation` (plain
torch on the CPU).  Counts must be byte-equal to the script's and to
kernel 1's plain version; the entries streamed per tile follow the skip
rule exactly.  The CUDA kernel is held against the same plain version on
the card (tests/test_torch_cuda.py).
"""

import importlib.util

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from conftest import REPO_ROOT
from rustsasa_tpu.ops import fused_kernel as ref
from rustsasa_tpu.ops.engine import _sphere_packed
from rustsasa_tpu_torch.ops import _kernels
from rustsasa_tpu_torch.ops import fused_kernel as port
from rustsasa_tpu_torch.scripts import r4_saturation

PROBE = 1.4
RADII = np.array([1.4, 1.55, 1.6, 1.7, 1.8, 1.9, 2.0], np.float32)
# The script's variant names by check interval.
VARIANTS = {1: "tilesat_vmem", 2: "sat2", 4: "sat4"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def script():
    """scripts/r4_saturation.py, loaded by path (it is no package module)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_r4_saturation", REPO_ROOT / "scripts" / "r4_saturation.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_cull_wire(seed=1):
    """pack_structures' f32 wire of a 4-tile chunk with one shared gid."""
    rng = np.random.default_rng(seed)
    structures = [
        ((rng.uniform(0, 20, (n, 3)) + 60.0).astype(np.float32),
         rng.choice(RADII, n), np.arange(n, dtype=np.int32))
        for n in (100, 380)
    ]
    gids = structures[1][2].copy()
    gids[7] = gids[6]
    structures[1] = (structures[1][0], structures[1][1], gids)
    planes, jlist, _offsets, failed = ref._pack_structures_numpy(
        structures, PROBE, 100
    )
    assert failed == [] and jlist.shape[0] == 4
    return planes, jlist


def _sphere(n_points):
    packed = _sphere_packed(n_points)
    s128 = np.zeros((packed.shape[0], 128), np.float32)
    s128[:, 0:4] = packed
    return torch.from_numpy(packed), s128


@pytest.mark.parametrize("check_every", [1, 2, 4])
def test_counts_byte_equal_script(script, check_every):
    packed, s128 = _sphere(100)
    for planes, jlist in (_host_cull_wire(), r4_saturation.buried_block_wire()):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(script.run_variant_counts(
                planes, jlist, s128, variant=VARIANTS[check_every],
                check_every=check_every,
            )).astype(np.int32)
        p, j = port.to_device((planes, jlist), "cpu")
        got, streamed = r4_saturation.saturation_counts_reference(
            p, j, packed, check_every=check_every
        )
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), port.fused_counts_reference(p, j, packed).numpy()
        )
        assert bool((streamed <= 2 * j[:, 0]).all())  # 2 point passes


# P = 104 (2 passes of K = 13) and 960 (15 passes of K = 16).
@pytest.mark.parametrize("n_points", [100, 960])
def test_skip_fires_on_buried_block(n_points):
    p, j = port.to_device(r4_saturation.buried_block_wire(), "cpu")
    packed = torch.from_numpy(_sphere_packed(n_points))
    passes, _k = _kernels.point_passes(packed.shape[0])
    assert passes == (2 if n_points == 100 else 15)
    prod = port.fused_counts_reference(p, j, packed)
    assert int(prod[:128].max()) == 0  # the block is buried
    # Tile 0 saturates after its third entry: checked every entry it stops
    # there, every 2 or 4 entries at the check after; the shell tiles
    # stream all 7 entries of every pass.
    for check_every, stop in ((1, 3), (2, 4), (4, 4)):
        got, streamed = r4_saturation.saturation_counts_reference(
            p, j, packed, check_every=check_every
        )
        assert torch.equal(got, prod)
        assert streamed.tolist() == [passes * stop, passes * 7, passes * 7]


def test_check_every_must_be_positive():
    p, j = port.to_device(r4_saturation.buried_block_wire(), "cpu")
    packed = torch.from_numpy(_sphere_packed(100))
    with pytest.raises(ValueError, match="check_every"):
        r4_saturation.saturation_counts(p, j, packed, check_every=0)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.saturation_count(p, j, packed, 1)


def test_run_on_cpu_equals_prod():
    rng = np.random.default_rng(2)
    triples = [
        ((rng.uniform(0, 20, (n, 3)) + 40.0).astype(np.float32),
         rng.choice(RADII, n), np.arange(n, dtype=np.int32))
        for n in (90, 260)
    ]
    result = r4_saturation.run(triples, "cpu", slots=640, reps=1)
    assert result["tiles"] == 1 + 3 and result["failed"] == 0
    assert list(result["variants"]) == ["prod", "sat1", "sat2", "sat4"]
    assert result["entries"] > 0 and result["margins"] > 0
    for v in result["variants"].values():
        assert v["max_dcount"] == 0 and 0.0 <= v["skipped"] < 1.0
