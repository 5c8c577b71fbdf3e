"""The count kernel's reach skip, on the CPU (csrc/fused_count.cu).

The kernel leaves out of an i-atom's max the j-rows that no atom of its
warp keeps under `fused_kernel.reach_keep`, a conservative f32 test with
a slack.  `fused_counts_kept_reference` is the plain model of that
skip: the counts from the rows the kernel streams.  Here it is held
byte-equal to `fused_counts_reference` on near-tangent pairs, where an
exact reach test would flip counts, and on a q13 chunk of FreeSASA
structures, where the JAX package's Pallas kernel (interpret mode) is
byte-equal too (on the tangent pairs it is held to a rounding bound),
and on pairs spread past tangency, where the distance skip fires at its
worst radius ratio and its guard keeps smaller ones; and the work counts of `reach_work` (chip_smoke.py's bound) are pinned on a
small hand-made chunk.  The kernel itself is held against the model on
the card (tests/test_torch_cuda.py).
"""

import os

import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from rustsasa_tpu.ops import fused_kernel as ref
from rustsasa_tpu_torch.ops import _kernels, engine
from rustsasa_tpu_torch.ops import fused_kernel as fk
from rustsasa_tpu_torch.scripts import _study

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sphere(n_points):
    return engine._sphere_device(n_points, CPU)


def _tangent(n_points, seed, n_atoms=400, far=False):
    planes, jlist, real = _study.tangent_chunk(n_points, n_atoms, seed,
                                               far=far)
    return (torch.from_numpy(planes), torch.from_numpy(jlist),
            torch.from_numpy(real))


def _exact_keep(v2, ri, rj, gi, gj, far_ok):
    """The reference scripts' reach test, v2 - (r_i + r_j)^2 < 0, with no
    slack (reach_count.cu atom_reach)."""
    reach = ri + rj
    drop = (gi == 0.0) | (gj == 0.0) | (gj == gi)
    return ((v2 - reach * reach) < 0.0) & ~drop


def _pallas_counts(planes, jlist, sphere):
    """The JAX package's count kernel in interpret mode -> [M] i32."""
    s128 = np.zeros((sphere.shape[0], 128), np.float32)
    s128[:, 0:4] = sphere.numpy()
    return torch.from_numpy(np.asarray(ref._counts_call(
        planes.numpy(), jlist.numpy(), s128, interpret=True)).reshape(-1)
        .astype(np.int32))


@pytest.mark.parametrize("n_points, seed", [(100, 0), (60, 1)])
def test_skip_model_byte_equal_on_tangent_pairs(n_points, seed):
    planes, jlist, real = _tangent(n_points, seed)
    sphere = _sphere(n_points)
    want = fk.fused_counts_reference(planes, jlist, sphere)
    got = fk.fused_counts_kept_reference(planes, jlist, sphere)
    assert torch.equal(got[real], want[real])
    # The rows streamed are fewer than the admitted ones.
    work = fk.reach_work(planes, jlist, sphere)
    assert 0 < work["kept"] < work["admitted"]
    # In interpret mode on XLA's CPU backend the JAX package's kernel has
    # its products and sums contracted into fused multiply-adds, and
    # these pairs sit within a rounding of tangency: a few atoms (3-6 of
    # 400 over the seeds tried, by 1-4 points) differ from the strictly
    # rounded reference there.  On structures (below) they are byte-equal.
    diff = (_pallas_counts(planes, jlist, sphere) - want).abs()[real]
    assert int((diff > 0).sum()) <= 8 and int(diff.max()) <= 5


def _pairs(planes, real):
    """Every (i, j) pair of real atoms of a chunk as the kernel rounds
    it: (v2, r_i, r_j, gid_i, gid_j), each [N, N]."""
    x, y, z, r, g = (planes[row][real] for row in range(5))
    vx, vy, vz = (a[:, None] - a[None, :] for a in (x, y, z))
    v2 = (vx * vx + vy * vy) + vz * vz
    return v2, r[:, None], r[None, :], g[:, None], g[None, :]


@pytest.mark.parametrize("n_points, seed", [(100, 2), (60, 3), (1000, 4)])
def test_skip_model_byte_equal_past_tangency(n_points, seed):
    """Pairs at the edge of the distance skip's slack and spread from
    tangency to 2 x 2^-14 past it, half of them with r_j about r_i / 8:
    the skip fires at its edge and at its worst radius ratio, and its
    guard keeps pairs with r_j just below r_i / 8; the counts do not
    move."""
    planes, jlist, real = _tangent(n_points, seed, far=True)
    sphere = _sphere(n_points)
    want = fk.fused_counts_reference(planes, jlist, sphere)
    got = fk.fused_counts_kept_reference(planes, jlist, sphere)
    assert torch.equal(got[real], want[real])
    work = fk.reach_work(planes, jlist, sphere)
    v2, ri, rj, gi, gj = _pairs(planes, real)
    gids = (gi != gj)
    far = fk.reach_far(v2, ri, rj) & gids
    assert int(far.sum()) == work["far"] > 0
    # Skipped within 2^-16 of the skip's edge at r_j <= 0.16 r_i, and
    # kept within 2^-16 below it (the coordinates' roundings, ~2^-18 of
    # v2 at these distances from the origin, place the pairs no closer).
    reach2 = (ri + rj) * (ri + rj)
    edge = reach2 * fk.REACH_SLACK
    small = rj <= 0.16 * ri
    assert int((far & small & (v2 <= edge * (1.0 + 2.0 ** -16))).sum()) > 0
    below = gids & small & (v2 >= edge * (1.0 - 2.0 ** -16)) & (v2 <= edge)
    assert int(below.sum()) > 0
    assert fk.reach_keep(v2, ri, rj, gi, gj, True)[below].all()
    # Past the slack but below the radius guard: kept.
    guarded = ((v2 > reach2 * fk.REACH_SLACK) & (rj * 8.0 < ri) & gids)
    assert int(guarded.sum()) > 0
    assert fk.reach_keep(v2, ri, rj, gi, gj, True)[guarded].all()


@pytest.mark.parametrize("n_points, seed", [(100, 0), (60, 1)])
def test_exact_reach_test_flips_counts_on_tangent_pairs(n_points, seed,
                                                        monkeypatch):
    planes, jlist, real = _tangent(n_points, seed)
    sphere = _sphere(n_points)
    want = fk.fused_counts_reference(planes, jlist, sphere)
    monkeypatch.setattr(fk, "reach_keep", _exact_keep)
    exact = fk.fused_counts_kept_reference(planes, jlist, sphere)
    assert int((exact != want)[real].sum()) >= 1


def test_skip_model_byte_equal_on_freesasa_q13_chunk():
    structures = [_study.select(os.path.join(_study.TEST_STRUCTURES, f))
                  for f in ("2drt.pdb.gz", "2gpi.pdb.gz", "1jcd.pdb.gz")]
    wa, wb, pal, tp, tm, offsets = fk.pack_structures_q13(structures,
                                                          _study.PROBE)
    planes, qvalid = fk.dequant_q13(*fk.to_device((wa, wb, pal, tp), CPU))
    jlist = fk.build_jlist_banded(planes, qvalid, torch.from_numpy(tm), w=16)
    sphere = _sphere(100)
    real = _study.real_slots(offsets, planes.shape[1], CPU)
    want = fk.fused_counts_reference(planes, jlist, sphere)
    assert torch.equal(_pallas_counts(planes, jlist, sphere)[real],
                       want[real])
    got = fk.fused_counts_kept_reference(planes, jlist, sphere)
    assert torch.equal(got[real], want[real])
    work = fk.reach_work(planes, jlist, sphere)
    assert work["atoms"] == int(real.sum())
    reach = work["reach"]
    assert (reach[1] <= reach[4] <= reach[32] <= reach[128]
            <= work["admitted"])
    # The warp union under the slack keeps at least the exact one.
    assert reach[1] <= work["kept"] < work["admitted"]
    assert work["far"] > 0
    assert int(work["warp_rows"].sum()) > 0


def _hand_chunk():
    """One tile: atoms 0-3 real (0 and 3 coincident with one gid, 1 in
    reach of both, 2 far from all), the rest padding; one entry admitting
    all 16 groups of the tile."""
    planes = torch.zeros((fk.N_PLANES, 128))
    planes[0, :4] = torch.tensor([0.0, 2.0, 10.0, 0.0])
    planes[3, :4] = 1.5
    planes[4, :4] = torch.tensor([1.0, 2.0, 3.0, 1.0])
    jlist = torch.zeros((1, 128), dtype=torch.int32)
    jlist[0, 0] = 1
    jlist[0, 1] = torch.tensor(0xFFFF << 16, dtype=torch.int64).to(
        torch.int32)
    return planes, jlist


def test_reach_work_pinned_on_a_hand_made_chunk():
    planes, jlist = _hand_chunk()
    sphere = _sphere(100)
    work = fk.reach_work(planes, jlist, sphere)
    assert work["atoms"] == 4
    assert work["admitted"] == 4 * 128
    # In reach of the atom itself: 0 <- 1; 1 <- 0, 3; 3 <- 1.
    assert work["reach"] == {128: 12, 32: 12, 4: 12, 1: 4}
    # Skipped by distance: 2 <- 0, 1, 3 and 0, 1, 3 <- 2.
    assert work["far"] == 6
    # Warps {0, 1} keep rows 0, 1, 3; {2, 3} row 1 (for 3).
    assert work["kept"] == 3 * 2 + 1 * 2
    assert work["warp_rows"].tolist() == [[3, 1] + [0] * 62]
    # The instructions needed: 7 a point for each of the 4 pairs in
    # reach, 14 a reach test for each of the 512 admitted pairs.
    assert fk.needed_instructions(work, 100) == 7 * 100 * 4 + 14 * 512
    assert fk.needed_instructions(work, 100, fk.REACH_INSTR_SASS) == (
        7 * 100 * 4 + 17 * 512)


def test_a_long_sphere_point_turns_the_distance_skip_off():
    planes, jlist = _hand_chunk()
    sphere = _sphere(100).clone()
    assert fk.sphere_far_ok(sphere)
    sphere[7, :3] *= 1.0 + 2.0 ** -18
    assert not fk.sphere_far_ok(sphere)
    # Atom 2 (far, real) is then kept by its warp {2, 3}: rows 0, 1, 3
    # for 2 and rows 1, 2 for 3.
    work = fk.reach_work(planes, jlist, sphere)
    assert work["warp_rows"][0, 1] == 4 and work["far"] == 0
    sphere[7, 3] = 0.0  # an invalid point does not count
    assert fk.sphere_far_ok(sphere)


def test_the_skip_keeps_small_j_radii_and_tiny_i_radii():
    v2 = torch.tensor([100.0, 100.0, 100.0])
    ri = torch.tensor([1.0, 2.0, 1e-7])
    rj = torch.tensor([1.0, 0.2, 1.0])
    one, two = torch.tensor(1.0), torch.tensor(2.0)
    # Far in all three; only the first meets r_i >= 1e-6, 8 r_j >= r_i.
    assert fk.reach_keep(v2, ri, rj, one, two, True).tolist() == [
        False, True, True]
    assert fk.reach_keep(v2, ri, rj, one, two, False).tolist() == [
        True, True, True]
    # gid rules hold without the distance skip too.
    assert not fk.reach_keep(v2, ri, rj, one, one, False).any()
    assert not fk.reach_keep(v2, ri, rj, torch.tensor(0.0), two, False).any()


@pytest.mark.parametrize("p, passes, k", [
    (20, 1, 2), (100, 1, 7), (128, 1, 8), (129, 1, 9), (256, 1, 16),
    (257, 2, 9), (1000, 4, 16), (2048, 8, 16),
])
def test_lane_split(p, passes, k):
    assert _kernels.lane_passes(p) == (passes, k)


def test_rows_wrapper_checks_its_arguments():
    planes = torch.zeros((8, 128))
    jlist = torch.zeros((1, 128), dtype=torch.int32)
    sphere = torch.zeros((104, 4))
    # The debug instantiation is named, and refuses CPU tensors too.
    with pytest.raises(ValueError, match="fused_count_rows needs CUDA"):
        _kernels.fused_count(planes, jlist, sphere, rows=True)
    with pytest.raises(ValueError, match="fused_count needs CUDA"):
        _kernels.fused_count(planes, jlist, sphere)


def test_sass_mix_reads_the_block_before_a_vote():
    """scripts/sass_mix.py --before: the straight-line block from the
    branch before an instruction of the opcode to that instruction (how
    fused_count.cu's reach test is read)."""
    from rustsasa_tpu_torch.scripts import sass_mix

    code = [(0x00, "LDS R1, [R2]"), (0x10, "@!P0 BRA 0x60"),
            (0x20, "FADD R3, R1, -R4"), (0x30, "FMUL R3, R3, R3"),
            (0x40, "FSETP.LEU.OR P1, PT, R3, R5, !P2"),
            (0x50, "VOTE.ANY R6, PT, P1"), (0x60, "VOTE.ANY R7, PT, P1")]
    assert sass_mix.blocks_before(code, "VOTE.ANY") == [(2, 4), (2, 5)]
    assert sass_mix.mix(code, 2, 4) == {"FADD": 1, "FMUL": 1,
                                        "FSETP.LEU.OR": 1}
    assert sass_mix.blocks_before(code[:2], "LDS") == []
