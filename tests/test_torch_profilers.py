"""The port's profilers and micro bench on the CPU, and profile_fused against
the reference's `fused_sasa`.

`profile_native_pipeline`, `profile_pipeline`, `profile_fused` and
`benches/micro_bench` run at a tiny size (three FreeSASA structures, or
one for the micro bench) with the plain-torch kernels and must return
every stage they report.  profile_fused's per-slot SASA is held against
`rustsasa_tpu.ops.fused_kernel.fused_sasa` (Pallas in TPU interpret mode)
on the same packed planes: counts byte-equal, areas within 1e-3 A^2.
"""

import shutil

import numpy as np
import pytest
pytest.importorskip("torch")
import torch
from jax.experimental.pallas import tpu as pltpu

from conftest import REFERENCE_DATA
from rustsasa_tpu.ops import fused_kernel as ref
from rustsasa_tpu.ops.engine import _FUSED_M_BUCKETS
from rustsasa_tpu.ops.engine import _sphere_packed as ref_sphere_packed
from rustsasa_tpu_torch.benches import micro_bench
from rustsasa_tpu_torch.ops import engine
from rustsasa_tpu_torch.ops import fused_kernel as port
from rustsasa_tpu_torch.scripts import (
    profile_fused, profile_native_pipeline, profile_pipeline,
)

SMALL_PDBS = ("2drt.pdb.gz", "2gpi.pdb.gz", "3uc7.pdb.gz")
WHERE = {"cpu_count", "gpu_name", "power_limit"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    for name in SMALL_PDBS:
        shutil.copy(REFERENCE_DATA / "freesasa_pdbs" / name, d / name)
    return str(d)


def _stage_values(result, keys):
    assert keys <= set(result), keys - set(result)
    for key in keys - WHERE:
        assert np.isfinite(result[key]) and result[key] >= 0, key
    assert result["gpu_name"] is None and result["cpu_count"] >= 1


def test_profile_native_pipeline(corpus, tmp_path):
    r = profile_native_pipeline.run(corpus, 3, device="cpu",
                                    out_dir=str(tmp_path))
    _stage_values(r, {"load_s", "pack_s", "device_s", "device2_s", "emit_s",
                      "sum_s", "matoms_s", "m", "avg_jtiles", "files",
                      "atoms", "workers"} | WHERE)
    assert r["files"] == 3 and r["m"] % 128 == 0 and r["atoms"] > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "0.json", "1.json", "2.json"]
    assert len(profile_native_pipeline.lines(r)) == 7


def test_profile_pipeline(corpus, tmp_path):
    r = profile_pipeline.run(corpus, 3, device="cpu", out_dir=str(tmp_path))
    _stage_values(r, {"parse_s", "select_s", "pack_s", "device_s",
                      "device2_s", "emit_s", "sum_s", "m", "files", "atoms",
                      "workers"} | WHERE)
    assert len(list(tmp_path.iterdir())) == 3
    assert profile_pipeline.lines(r)[0] == "3 files"


def test_profile_fused_equals_reference_fused_sasa(corpus):
    # Two structures: 10 tiles, padded to the 2,048-slot bucket.
    r = profile_fused.run(corpus, 2, device="cpu", reps=1)
    _stage_values(r, {"pack_s", "first_ms", "ms", "ns_per_jiter",
                      "cycles_per_jiter", "matoms_s", "fp32_instr_per_s",
                      "peak_share", "files", "atoms", "m", "m_pad", "tiles",
                      "jiters", "margins", "avg_jtiles", "failed",
                      "admitted_pairs", "reach_pairs", "streamed_pairs",
                      "instr", "bound_ms"} | WHERE)
    assert r["reach_pairs"] <= r["streamed_pairs"] < r["admitted_pairs"]
    assert profile_fused.FUSED_M_BUCKETS == _FUSED_M_BUCKETS
    planes, jlist, m, atoms, files, failed = profile_fused.packed_inputs(
        corpus, 2)
    assert (files, failed, m, atoms) == (2, 0, r["m"], r["atoms"])
    assert planes.shape[1] == r["m_pad"] == 2048 > m
    assert (jlist[m // 128:] == 0).all()  # padded tiles: empty j-lists

    packed = ref_sphere_packed(100)
    s128 = np.zeros((packed.shape[0], 128), np.float32)
    s128[:, 0:4] = packed
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref.fused_sasa(planes, jlist, s128, n_points=100,
                                         out_dtype=np.float32))
    np.testing.assert_allclose(r["sasa"], want, atol=1e-3, rtol=0)
    real = planes[4] > 0
    assert want[real].sum() > 0 and (r["sasa"][~real] == 0).all()
    # Counts: the areas over 4 pi r_eff^2 / n_points (<= 100, so exact
    # after rounding).
    unit = (planes[3] * np.float32(4.0 * np.pi / 100)) * planes[3]
    p, j = port.to_device((planes, jlist), "cpu")
    got = port.fused_counts(p, j, engine._sphere_device(
        100, torch.device("cpu"))).numpy()
    np.testing.assert_array_equal(
        got[real], np.rint(want[real] / unit[real]).astype(np.int32))


def test_micro_bench():
    r = micro_bench.run(str(REFERENCE_DATA / "freesasa_pdbs" / "2drt.pdb.gz"),
                        device="cpu")
    assert list(r["units_ms"]) == [
        "get_radius (ALA CA)", "parse example.cif (native)",
        "parse example.cif (python)", "build_atoms_and_mapping",
        "calculate_sasa (device)", "full_sasa_residue_level"]
    assert all(ms > 0 for ms in r["units_ms"].values())
    assert WHERE <= set(r)


@pytest.mark.parametrize("module", [profile_native_pipeline,
                                    profile_pipeline, profile_fused,
                                    micro_bench])
def test_default_device_is_cuda_without_fallback(module, corpus,
                                                  monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if module is micro_bench:
            module.run()
        else:
            module.run(corpus, 3)
