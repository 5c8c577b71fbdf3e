"""Parity of the port's round-4 micro-variant study with the reference
script `scripts/r4_microkernel.py` (CPU).

The same host-cull f32 wires (the reference's numpy packer, and the buried
lattice block of the saturation study) go through the script's Pallas
kernel in TPU interpret mode (`run_variant_counts`: f16 counts, exact up
to 2,048) and through `rustsasa_tpu_torch.scripts.r4_microkernel` (plain
torch on the CPU), for every loop shape.  Counts must be byte-equal to the
script's and to kernel 1's plain version at every slot.  The CUDA kernel
is held against the same plain version on the card
(tests/test_torch_cuda.py).
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
from rustsasa_tpu_torch.scripts import r4_microkernel, r4_saturation

PROBE = 1.4
RADII = np.array([1.4, 1.55, 1.6, 1.7, 1.8, 1.9, 2.0], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def script():
    """scripts/r4_microkernel.py, loaded by path (it is no package module)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_r4_microkernel", REPO_ROOT / "scripts" / "r4_microkernel.py"
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


@pytest.mark.parametrize("variant", r4_microkernel.VARIANTS)
def test_counts_byte_equal_script(script, variant):
    packed = _sphere_packed(100)
    s128 = np.zeros((packed.shape[0], 128), np.float32)
    s128[:, 0:4] = packed
    sphere = torch.from_numpy(packed)
    for planes, jlist in (_host_cull_wire(), r4_saturation.buried_block_wire()):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(script.run_variant_counts(
                planes, jlist, s128, variant=variant
            )).astype(np.int32)
        p, j = port.to_device((planes, jlist), "cpu")
        got = r4_microkernel.micro_counts(p, j, sphere, variant=variant)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), port.fused_counts_reference(p, j, sphere).numpy()
        )
        assert int(got.max()) > 0


def test_streamed_groups_per_variant():
    # Tile 0: masks of 1, 2, 3 and 16 groups, the last entry dead (past the
    # count); tile 1: one entry on a tile past the chunk's end.
    jlist = np.zeros((2, port.JLIST_ROWS), np.uint32)
    jlist[0, 0] = 3
    jlist[0, 1:5] = [(0x1 << 16) | 1, (0x5 << 16) | 0, (0x7 << 16) | 1,
                     (0xFFFF << 16) | 0]
    jlist[1, 0] = 1
    jlist[1, 1] = (0x3 << 16) | 9
    groups = r4_microkernel.streamed_groups(port.to_device((jlist,), "cpu")[0])
    assert groups == {"prod": 6, "split2": 6, "g16": 8, "g24": 9,
                      "nosmem": 48}


def test_variant_and_device_errors():
    p, j = port.to_device(r4_saturation.buried_block_wire(), "cpu")
    sphere = torch.from_numpy(_sphere_packed(100))
    with pytest.raises(ValueError, match="unknown variant"):
        r4_microkernel.micro_counts(p, j, sphere, variant="g32")
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.micro_count(p, j, sphere, "prod")
    with pytest.raises(ValueError, match="unsupported device"):
        r4_microkernel.micro_counts(p.to("meta"), j, sphere, variant="prod")


def test_run_on_cpu_equals_k1():
    rng = np.random.default_rng(2)
    triples = [
        ((rng.uniform(0, 20, (n, 3)) + 40.0).astype(np.float32),
         rng.choice(RADII, n), np.arange(n, dtype=np.int32))
        for n in (90, 260)
    ]
    result = r4_microkernel.run(triples, "cpu", slots=640, reps=1)
    assert result["tiles"] == 1 + 3 and result["failed"] == 0
    variants = result["variants"]
    assert list(variants) == ["k1", *r4_microkernel.VARIANTS]
    for v in variants.values():
        assert v["max_dcount"] == 0 and v["mean_dcount"] == 0.0
        assert v["ms"] > 0 and v["margins"] > 0
    k1 = variants["k1"]["groups"]
    assert variants["prod"]["groups"] == variants["split2"]["groups"] == k1
    assert k1 <= variants["g16"]["groups"] <= variants["nosmem"]["groups"]
    assert variants["g24"]["groups"] >= k1
