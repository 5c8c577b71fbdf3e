"""Parity of the port's round-3 reach-test study with the reference script
`scripts/r3_kernel_variants.py` (CPU).

The same host-cull f32 wire (the reference's numpy packer) goes through
the script's Pallas kernel in TPU interpret mode (`run_variant_counts`:
f16 counts, exact up to 2,048) and through
`rustsasa_tpu_torch.scripts.r3_kernel_variants` (plain torch on the CPU),
for every variant, bf16 included.  The script predates group masks and
reads the raw entry as the j-tile (a masked entry would point its copy
elsewhere, and interpret mode clamps instead of failing), so it is fed
the entries' low 16 bits; the port reads entry & 0xFFFF from the original
j-list.  Counts must be byte-equal, and the j-rows executed must follow
the script's skip rule, counted here in numpy.  The CUDA kernel is held
against the same plain version on the card (tests/test_torch_cuda.py).
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
from rustsasa_tpu_torch.scripts import r3_kernel_variants as r3v

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
    """scripts/r3_kernel_variants.py, loaded by path (no package module)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_r3_kernel_variants",
        REPO_ROOT / "scripts" / "r3_kernel_variants.py",
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_cull_wire(seed=1):
    """pack_structures' f32 wire of a 4-tile chunk with one shared gid,
    and its real-slot mask."""
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
    return planes, jlist, planes[4] > 0.0


def _sphere(n_points=100):
    packed = _sphere_packed(n_points)
    s128 = np.zeros((packed.shape[0], 128), np.float32)
    s128[:, 0:4] = packed
    return torch.from_numpy(packed), s128


def _executed_by_script_rule(planes, jlist, variant, passes):
    """[T] j-rows the script's kernel streams, in numpy: per live entry,
    hitmat = v2 - (r_i + r_j)^2 over the j-tile's rows x all 128 i lanes,
    a group runs when its min is < 0, and jskip/group4 then run only the
    rows whose min is < 0."""
    group = 4 if variant == "group4" else 8
    t = jlist.shape[0]
    out = np.zeros(t, np.int64)
    for tile in range(t):
        ci = planes[0:3, tile * 128:(tile + 1) * 128].T  # [A, 3]
        ri = planes[3, tile * 128:(tile + 1) * 128]
        for e in range(int(jlist[tile, 0])):
            jt = int(jlist[tile, 1 + e]) & 0xFFFF
            cj = planes[0:3, jt * 128:(jt + 1) * 128].T  # [J, 3]
            rj = planes[3, jt * 128:(jt + 1) * 128]
            v = ci[None, :, :] - cj[:, None, :]  # [J, A, 3]
            v2 = (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) \
                + v[..., 2] * v[..., 2]
            reach = ri[None, :] + rj[:, None]
            row_hit = (v2 - reach * reach).min(axis=1) < 0.0  # [J]
            group_hit = row_hit.reshape(-1, group).any(axis=1)
            if variant == "nogroupcond":
                out[tile] += 128
            elif variant in ("jskip", "group4"):
                out[tile] += int(row_hit.sum())
            else:
                out[tile] += group * int(group_hit.sum())
    return passes * out


@pytest.mark.parametrize("variant", r3v.VARIANTS)
def test_counts_byte_equal_script(script, variant):
    planes, jlist, real = _host_cull_wire()
    packed, s128 = _sphere()
    raw = jlist.copy()
    raw[:, 1:] &= np.uint32(0xFFFF)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(script.run_variant_counts(
            planes, raw, s128, variant=variant
        )).astype(np.int32)
    p, j = port.to_device((planes, jlist), "cpu")
    assert int(j[1:, 1:].min()) < 0  # full masks: negative entries
    got, executed = r3v.reach_counts(p, j, packed, variant=variant)
    np.testing.assert_array_equal(got.numpy(), want)
    passes, _k = _kernels.point_passes(packed.shape[0])
    np.testing.assert_array_equal(
        executed.numpy(), _executed_by_script_rule(planes, jlist, variant,
                                                   passes)
    )
    prod = port.fused_counts_reference(p, j, packed).numpy()
    if variant in r3v.F32_VARIANTS:
        np.testing.assert_array_equal(got.numpy()[real], prod[real])
    else:  # bf16 moves boundary points, a few per atom
        d = np.abs(got.numpy()[real] - prod[real])
        assert 0 < d.max() <= 8 and d.mean() < 0.5


def test_padded_rows_at_origin_trip_reach():
    # A structure centred on one of its atoms: the packer moves that atom
    # to the origin, where the padding slots of its last tile sit (r = 0,
    # gid 0), so their rows are in reach.  Moving the padding away changes
    # what executes, not the atoms' counts (a padding row's limit is
    # -1e30).
    rng = np.random.default_rng(3)
    half = rng.uniform(-12, 12, (70, 3)).astype(np.float32)
    coords = np.concatenate([[[0.0, 0.0, 0.0]], half, -half]) + 60.0
    structures = [(coords.astype(np.float32), rng.choice(RADII, 141),
                   np.arange(141, dtype=np.int32))]
    planes, jlist, _offsets, failed = ref._pack_structures_numpy(
        structures, PROBE, 100
    )
    assert failed == [] and jlist.shape[0] == 2
    real = torch.from_numpy(planes[4] > 0.0)
    moved = planes.copy()
    moved[0:3, ~real.numpy()] = 1000.0
    packed, _s128 = _sphere()
    for variant in ("base", "jskip", "bf16"):
        at_origin = r3v.reach_counts(*port.to_device((planes, jlist), "cpu"),
                                     packed, variant=variant)
        away = r3v.reach_counts(*port.to_device((moved, jlist), "cpu"),
                                packed, variant=variant)
        assert torch.equal(at_origin[0][real], away[0][real]), variant
        assert bool((at_origin[1] >= away[1]).all()), variant
        assert int(at_origin[1].sum()) > int(away[1].sum()), variant


def test_variant_and_device_errors():
    planes, jlist, _real = _host_cull_wire()
    p, j = port.to_device((planes, jlist), "cpu")
    packed, _s128 = _sphere()
    with pytest.raises(ValueError, match="unknown variant"):
        r3v.reach_counts(p, j, packed, variant="fp8")
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.reach_count(p, j, packed, "base")
    with pytest.raises(ValueError, match="unsupported device"):
        r3v.reach_counts(p.to("meta"), j, packed, variant="base")


def test_run_on_cpu():
    rng = np.random.default_rng(2)
    triples = [
        ((rng.uniform(0, 20, (n, 3)) + 40.0).astype(np.float32),
         rng.choice(RADII, n), np.arange(n, dtype=np.int32))
        for n in (90, 260)
    ]
    result = r3v.run(triples, "cpu", slots=640, reps=1)
    assert result["tiles"] == 1 + 3 and result["failed"] == 0
    variants = result["variants"]
    assert list(variants) == ["k1", *r3v.VARIANTS]
    for name in r3v.F32_VARIANTS:
        assert variants[name]["max_dcount"] == 0, name
    per_atom = {k: v["j_atoms_per_atom"] for k, v in variants.items()}
    assert per_atom["nogroupcond"] >= per_atom["base"] >= per_atom["jskip"]
    assert per_atom["jskip"] == per_atom["group4"]
    assert per_atom["base"] == per_atom["nocond"] == per_atom["bf16"]
    assert all(v["ms"] > 0 and v["margins"] > 0 for v in variants.values())
