"""The port's link and shape tools on the CPU, at a tiny size:
`scripts/r3_link_floor.py`, `scripts/r3_split.py` and
`scripts/precompile_fused.py`.

The reference's scripts run at import (and need a TPU), so they are
read, never imported: precompile_fused's row lists and its structure
generator are taken from the reference script's syntax tree.  r3_split's
host-cull f32 route is held byte-equal to the reference's
`fused_kernel.fused_sasa` (Pallas in TPU interpret mode, f32 readback)
on the same 4-file corpus.  Times from these runs are the CPU's and are
only checked for shape.
"""

import ast
import json
import shutil

import numpy as np
import pytest
pytest.importorskip("torch")
import torch
from jax.experimental.pallas import tpu as pltpu

from conftest import REFERENCE_DATA, REPO_ROOT
from rustsasa_tpu.ops import fused_kernel as ref
from rustsasa_tpu.ops.engine import _FUSED_M_BUCKETS
from rustsasa_tpu.ops.engine import _sphere_packed as ref_sphere_packed
from rustsasa_tpu_torch.ops import fused_kernel as fk
from rustsasa_tpu_torch.scripts import precompile_fused, r3_link_floor, r3_split

CORPUS = ("2drt.pdb.gz", "2gpi.pdb.gz", "3uc7.pdb.gz", "3w7y.pdb.gz")
SMALL_M_PAD = 4096
WHERE = {"cpu_count", "gpu_name", "power_limit"}
LINK_KEYS = {
    "dispatch_floor_median_ms", "dispatch_floor_min_ms", "h2d_16mb_mbps",
    "d2h_16mb_mbps", "h2d_64mb_mbps", "d2h_64mb_mbps",
    "fused_single_protein_device_median_ms",
}


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
    for name in CORPUS:
        shutil.copy(REFERENCE_DATA / "freesasa_pdbs" / name, d / name)
    return str(d)


@pytest.fixture(scope="module")
def split(corpus, tmp_path_factory):
    return r3_split.run(corpus, "cpu", slots=SMALL_M_PAD, reps=1,
                        out_dir=str(tmp_path_factory.mktemp("out")))


def test_link_floor_record_has_the_references_keys():
    r = r3_link_floor.run("cpu", floor_reps=3, copy_reps=1, fused_reps=1)
    assert LINK_KEYS <= set(r)
    for key in LINK_KEYS:
        assert np.isfinite(r[key]) and r[key] > 0, key
    # No memory is pinned on the CPU.
    assert {k: v for k, v in r.items() if "pinned" in k} == {
        f"{d}_{mb}mb_pinned_mbps": None for d in ("h2d", "d2h")
        for mb in (16, 64)}
    assert r["single_slots"] == 4096 and r["single_counts_sum"] > 0
    assert WHERE <= set(r) and r["gpu_name"] is None


def test_link_floor_structure_is_the_references():
    """The reference draws the two copy buffers, then the structure, from
    one default_rng(0), packs it on the q16 wire and pads it to its
    engine's bucket."""
    rng = np.random.default_rng(0)
    for mb in r3_link_floor.COPY_MB:
        rng.random((mb * 1024 * 1024 // 4,))
    *got, m_pad = r3_link_floor.single_protein_wire(rng)
    rng = np.random.default_rng(0)
    for mb in (16, 64):
        rng.random((mb * 1024 * 1024 // 4,))
    n = 2622
    coords = (rng.random((n, 3)) * 40).astype(np.float32)
    planes4, tparams, tmeta, _ = ref.pack_structures_q16(
        [(coords, np.full(n, 1.7, np.float32), np.arange(n, dtype=np.int32))],
        1.4)
    m = planes4.shape[1]
    assert m_pad == min(b for b in _FUSED_M_BUCKETS if b >= m) == 4096
    pad_t = (m_pad - m) // 128
    want = (np.pad(planes4, ((0, 0), (0, m_pad - m))),
            np.pad(tparams, ((0, pad_t), (0, 0))),
            np.pad(tmeta, ((0, pad_t), (0, 0))))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_split_records_carry_the_references_figures(corpus, split):
    assert split["files"] == len(CORPUS)
    assert split["atoms"] == sum(t[0].shape[0]
                                 for t in r3_split.load_triples(corpus)) > 0
    for name, s in split["routes"].items():
        assert set(r3_split.SPLIT_KEYS) <= set(s), name
        assert len(s["e2e_ms"]) == len(s["kernels_ms"]) == 1
        assert s["first_s"] > 0 and s["h2d_ms"] > 0 and s["d2h_ms"] > 0
        assert s["e2e_equals_kernels"], name
    assert split["routes"]["f32"]["slots"] == SMALL_M_PAD
    assert list(split["routes"]["f32"]["stage_ms"][0]) == ["fused_count"]
    q13 = split["routes"]["q13"]
    assert list(q13["stage_ms"][0]) == ["dequant_boxes", "band_jlist",
                                        "fused_count"]
    assert q13["equals_engine"] and q13["w"] == 16
    assert q13["slots"] < SMALL_M_PAD  # the q13 wire is not padded
    assert WHERE <= set(split) and split["gpu_name"] is None
    assert len(r3_split.lines(split)) == 2 + 7 * 2 + 1
    line = json.loads(json.dumps(r3_split.record(split)))
    assert "out" not in line["routes"]["q13"]
    assert line["pass"] == split["pass"]


def test_split_bench_pass(split):
    p = split["pass"]
    assert (p["n_files"], p["n_ok"], p["errors"]) == (4, 4, 0)
    assert p["chunks"] == sum(p["routes"].values()) == 1
    assert 0.0 < p["busy_ms"] <= p["wall_s"] * 1e3
    assert p["idle_share"] == pytest.approx(
        1.0 - p["busy_ms"] / (p["wall_s"] * 1e3))
    # The plain versions launch nothing.
    assert set(p["launches"].values()) == {0}


def test_split_host_cull_counts_equal_the_references(corpus, split):
    """The f32 route's areas (kernel 1's counts times each slot's area)
    byte-equal to the reference's fused_sasa on the same wire; so are
    the counts they come from."""
    triples = r3_split.load_triples(corpus)
    planes, jlist, failed = r3_split.host_cull_wire(triples, SMALL_M_PAD)
    assert failed == []
    packed = ref_sphere_packed(100)
    s128 = np.zeros((packed.shape[0], 128), np.float32)
    s128[:, 0:4] = packed
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref.fused_sasa(planes, jlist, s128, n_points=100,
                                         out_dtype=np.float32))
    got = split["routes"]["f32"]["out"]
    np.testing.assert_array_equal(got, want)
    real = planes[4] > 0
    assert want[real].sum() > 0 and (got[~real] == 0).all()
    unit = (planes[3] * np.float32(4.0 * np.pi / 100)) * planes[3]
    np.testing.assert_array_equal(np.rint(got[real] / unit[real]),
                                  np.rint(want[real] / unit[real]))


def test_split_times_the_engines_entry_point(corpus, split, monkeypatch):
    """The q13 route runs fused_sasa_q13_banded itself, whose mark hook
    follows its three stages in order and leaves its counts as they are
    without it."""
    triples = r3_split.load_triples(corpus)[:2]
    wire, offsets, w = r3_split.q13_wire(triples)
    d = fk.to_device(wire, torch.device("cpu"))
    sphere = r3_split.engine._sphere_device(r3_split.N_POINTS,
                                            torch.device("cpu"))
    stages = []
    got = fk.fused_sasa_q13_banded(*d, sphere, n_points=r3_split.N_POINTS,
                                   w=w, mark=stages.append)
    assert stages == ["dequant_boxes", "band_jlist", "fused_count"]
    assert torch.equal(got, fk.fused_sasa_q13_banded(
        *d, sphere, n_points=r3_split.N_POINTS, w=w))
    calls = []
    real = fk.fused_sasa_q13_banded
    monkeypatch.setattr(fk, "fused_sasa_q13_banded",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    monkeypatch.setattr(r3_split, "bench_pass", lambda *a: split["pass"])
    r = r3_split.run(corpus, "cpu", files=2, slots=SMALL_M_PAD, reps=1)
    # The first call, one e2e and one kernels-alone run; the engine's
    # dispatch for equals_engine is the fourth.
    assert len(calls) == 4 and all("mark" in k for k in calls[:3])
    assert r["routes"]["q13"]["equals_engine"]
    np.testing.assert_array_equal(r["routes"]["q13"]["out"], got.numpy())


def test_split_chunk_events_restore_the_entry_points():
    saved = {n: getattr(fk, n) for n in r3_split.CHUNK_FUNCTIONS}
    with r3_split.chunk_events(torch.device("cpu")) as ms:
        assert all(getattr(fk, n) is not saved[n] for n in saved)
    assert all(getattr(fk, n) is saved[n] for n in saved) and ms == []


# --- precompile_fused ----------------------------------------------------

def _reference_tree():
    return ast.parse((REPO_ROOT / "scripts" / "precompile_fused.py")
                     .read_text())


def _for_loops(tree):
    return [node for node in tree.body if isinstance(node, ast.For)]


def test_precompile_rows_equal_the_references():
    bucket, w_band, q16 = _for_loops(_reference_tree())
    assert ast.unparse(bucket.iter) == "E._FUSED_M_BUCKETS"
    assert precompile_fused.FUSED_M_BUCKETS == _FUSED_M_BUCKETS
    assert ast.unparse(w_band.target) == "(m, big_n)"
    assert ast.literal_eval(w_band.iter) == precompile_fused.W_BAND_ROWS
    assert ast.unparse(q16.target) == "(m, big_n, w_n)"
    assert ast.literal_eval(q16.iter) == precompile_fused.Q16_ROWS
    assert len(precompile_fused.W_BAND_ROWS) == 25
    assert len(precompile_fused.Q16_ROWS) == 8
    rows = precompile_fused.all_rows()
    assert len(rows) == len(_FUSED_M_BUCKETS) + 25 + 8
    assert [r.label for r in rows][:9] == [
        f"bucket {m}" for m in _FUSED_M_BUCKETS] + [
        "bucket 4096 w-band(2600 atoms)"]


def test_precompile_structures_are_the_references():
    """The reference's RSET and protein_like, taken from its tree and run
    on one generator, give the port's structures for every kind of row."""
    tree = _reference_tree()
    rset = next(node for node in tree.body if isinstance(node, ast.Assign)
                and ast.unparse(node.targets[0]) == "RSET")
    np.testing.assert_array_equal(
        np.array(ast.literal_eval(rset.value.args[0]), np.float32),
        precompile_fused.RSET)
    fn = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef)
              and node.name == "protein_like")
    scope = {"np": np, "rng": np.random.default_rng(0),
             "RSET": precompile_fused.RSET}
    exec(compile(ast.Module([fn], []), "precompile_fused", "exec"), scope)
    rng = np.random.default_rng(0)
    for n, extent in ((2000, None), (2600, None), (4000, 200.0)):
        want = scope["protein_like"](n, extent=extent)
        got = precompile_fused.protein_like(rng, n, extent)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        assert got[2] is want[2] is None


@pytest.mark.parametrize("row, wire", [
    (precompile_fused.Row("bucket", 2048), "q13"),
    (precompile_fused.Row("q16", 2048, 2000), "q16"),
])
def test_precompile_row_on_the_cpu(row, wire):
    lines = []
    r = precompile_fused.run("cpu", rows=[row], say=lines.append)
    assert r["build_s"] == 0.0 and WHERE <= set(r)
    assert [(s["m"], s["w"], s["first_s"], s["warm_s"]) for s in r["shapes"]
            ] == [(m, w, 0.0, 0.0) for m, w in
                  precompile_fused.engine.BatchedSasaEngine._WARM_SHAPES]
    none = dict.fromkeys(precompile_fused.KERNELS, 0)
    assert all(s["launches"] == [none, none] for s in r["shapes"])
    assert [(p["threads"], p["s"], p["launches"]) for p in
            r["pool_vs_serial"]] == [(t, 0.0, none) for t in (None, 1, 1, None)]
    (rec,) = r["rows"]
    assert (rec["structures"], rec["atoms"], rec["slots"]) == (1, 2000, 2048)
    assert rec["routes"] == {wire: 1} and rec["chunks"] == 1
    assert [(c["routes"], c["launches"]) for c in rec["calls"]] == [
        ({wire: 1}, none)] * 3
    assert [c["ms"] for c in rec["calls"]] == [rec["first_ms"],
                                               *rec["warm_ms"]]
    assert rec["launches"] == none
    # The plain versions launch nothing: the process's totals are 0.
    assert set(r["launches"].values()) == {0}
    assert rec["first_ms"] > 0 and len(rec["warm_ms"]) == 2
    assert not rec["split"] and "split" not in lines[-1]
    assert lines[-1].startswith(row.label + ": first call")


def test_precompile_quick_rows_cover_each_wire_and_width():
    """--quick: one row a wire at w = 16, 32 and 127, as the engine picks
    the width from the row's largest structure."""
    got = []
    for row in precompile_fused.QUICK_ROWS:
        atoms = row.big or precompile_fused.FILL_ATOMS
        tiles = -(-atoms // fk.ATOM_TILE)
        w = next(b for b in fk.W_BUCKETS if b >= tiles)
        got.append(("q16" if row.kind == "q16" else "q13", w))
    assert got == [(wire, w) for wire in ("q13", "q16") for w in (16, 32, 127)]


def test_precompile_line_says_when_a_row_is_split():
    rec = {"label": "bucket 4194304 w-band(8000 atoms)", "warm_ms": [1.0, 2.0],
           "matoms_s": [3.0, 4.0], "first_ms": 5.0, "atoms": 4_100_000,
           "routes": {"q13": 2}, "launches": {}, "split": True,
           "slots": 4_194_304, "chunks": 2}
    assert precompile_fused.line(rec).endswith(
        "4194304 slots exceed the 2097152-slot chunk budget: split into 2 "
        "chunks")
    assert [r.m > 2_097_152 for r in precompile_fused.all_rows()].count(
        True) == 2
