"""Parity of the port's kernel experiments with the reference script
`scripts/kernel_experiments.py` (CPU).

The script's six `make_*` kernels run through a `pallas_call` with its
`run_*` specs in TPU interpret mode, at T = 2 tiles and NJ = 32 j-rows
(128 for the max-plus kernels, whose loop runs NJ // 128 j-tiles), on
the script's own sphere and planes.  XLA-CPU's `jnp.sum` over the 128
points is in an order of its own, so in most cases the script's module
attribute `jnp` is swapped for a proxy whose `sum` adds the points in
order p = 0..127, as the port does.  The proxy's `ones_like`, with which
the script fills its resident j-data, can hand the script the port's
seeded random j-data instead, on which the gid mask and the reach test
fire.  One case per family runs the script unpatched.  The script's file
is not changed.

XLA-CPU contracts multiplies into adds inside these kernels (LLVM forms
fused multiply-adds in each fused loop, in an order that depends on the
fusion): test_xla_cpu_contracts_the_script_kernels pins it for `full`,
byte for byte.  The port computes the script's source as written, each
multiply and add rounded once, as the TPU's vector unit does; so the
sums are held to the bound of that rounding difference (and of the
summation order, for the unpatched cases).  DEFAULT precision is full
f32 on XLA-CPU; the port rounds the dot operands to bf16, as a bf16
matrix unit does, held to that rounding's bound as well.  The CUDA
kernels are held byte for byte against the same plain versions on the
card (tests/test_torch_cuda.py).
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import rustsasa_tpu.utils.jax_cache as jax_cache
from conftest import REPO_ROOT
from rustsasa_tpu_torch.ops import _kernels
from rustsasa_tpu_torch.scripts import kernel_experiments as ke
from rustsasa_tpu_torch.ops.fma import dot3, fma_f32

T_SMALL = 2
NJ_SMALL = 32
NJ_MAXPLUS = 128
F32 = jnp.float32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def script():
    """scripts/kernel_experiments.py, loaded by path.  Marking the
    persistent compile cache as enabled first makes the script's
    import-time enable_persistent_cache() a no-op: no .jax_cache/ and no
    change to JAX's config."""
    enabled = jax_cache._enabled
    jax_cache._enabled = True
    try:
        spec = importlib.util.spec_from_file_location(
            "_reference_kernel_experiments",
            REPO_ROOT / "scripts" / "kernel_experiments.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax_cache._enabled = enabled
    return mod


class SequentialJnp:
    """jax.numpy with a `sum` over axis 0 that adds rows in order, and a
    `ones_like` that returns `jdata` (the j-data a wrapping kernel read
    from an extra input) instead of ones when it is set."""

    def __init__(self):
        self.jdata = None

    def __getattr__(self, name):
        return getattr(jnp, name)

    def sum(self, x, axis=None, keepdims=False):
        assert axis == 0, axis
        acc = x[0:1]
        for p in range(1, x.shape[0]):
            acc = acc + x[p:p + 1]
        return acc if keepdims else acc[0]

    def ones_like(self, x):
        if self.jdata is None:
            return jnp.ones_like(x)
        assert self.jdata.shape == x.shape, (self.jdata.shape, x.shape)
        return self.jdata.astype(x.dtype)


def _maker(s, variant):
    """(kernel, scratch shapes) of `variant` as the script's run_* build
    them."""
    nj = s.NJ
    v1 = [pltpu.VMEM((3, s.P, s.A), F32), pltpu.VMEM((nj, 8), F32)]
    v3 = [pltpu.VMEM((s.P, s.A), F32), pltpu.VMEM((nj, 128), F32)]
    table = {
        "full": lambda: (s.make_kernel("full"), v1),
        "noscalar": lambda: (s.make_kernel("noscalar"), v1),
        "nogid": lambda: (s.make_kernel("nogid"), v1),
        "nobig": lambda: (s.make_kernel("nobig"), v1),
        "group8": lambda: (s.make_grouped_kernel(8, False), v1),
        "group8_smem": lambda: (s.make_grouped_kernel(8, True),
                                [v1[0], pltpu.SMEM((nj, 8), F32)]),
        "g8": lambda: (s.make_v2_kernel(False, False), v1),
        "g8_fma": lambda: (s.make_v2_kernel(True, False), v1),
        "g8_fma_skip": lambda: (s.make_v2_kernel(True, True), v1),
        "g8_hoist": lambda: (s.make_v2_kernel(False, False, hoist=True), v1),
        "g8_hoist_skip": lambda: (s.make_v2_kernel(False, True, hoist=True),
                                  v1),
        "g8_bf16": lambda: (s.make_bf16_kernel(False),
                            [pltpu.VMEM((3, s.P, s.A), jnp.bfloat16), v1[1]]),
        "g8_bf16_skip": lambda: (s.make_bf16_kernel(True),
                                 [pltpu.VMEM((3, s.P, s.A), jnp.bfloat16),
                                  v1[1]]),
        "mxu_dots_hi": lambda: (s.make_mxu_dots_kernel("HIGHEST", False),
                                [v1[1]]),
        "mxu_dots_def": lambda: (s.make_mxu_dots_kernel("DEFAULT", False),
                                 [v1[1]]),
        "mxu_dots_hi_skip": lambda: (s.make_mxu_dots_kernel("HIGHEST", True),
                                     [v1[1]]),
    }
    v3_args = {
        "mp_tile_hi": (True, True, "HIGHEST", False, False),
        "mp_tile_def": (True, True, "DEFAULT", False, False),
        "mp_tile_hi_skip": (True, True, "HIGHEST", True, False),
        "mp_group_hi": (False, False, "HIGHEST", False, False),
        "mp_group_def": (False, False, "DEFAULT", False, False),
        "mp_tile_hi_sat": (True, True, "HIGHEST", False, True),
    }
    if variant in v3_args:
        return s.make_v3_kernel(*v3_args[variant]), v3
    return table[variant]()


def _script_sums(script, variant, planes, sphere128, jdata=None,
                 sequential=True):
    """The script's kernel for `variant` in interpret mode -> [T*A].  With
    `jdata`, the kernel is wrapped to take it as one more input, which the
    proxy's ones_like hands to the script's resident j-data."""
    family = ke.VARIANTS[variant][0]
    saved = script.T, script.NJ, script.jnp
    script.T = planes.shape[1] // ke.A
    script.NJ = NJ_MAXPLUS if family == "maxplus" else NJ_SMALL
    proxy = SequentialJnp()
    if sequential:
        script.jnp = proxy
    else:
        assert jdata is None
    try:
        kernel, scratch = _maker(script, variant)
        m = planes.shape[1]
        in_specs = [
            pl.BlockSpec((script.P, 128), lambda i: (0, 0)),
            pl.BlockSpec((8, script.A), lambda i: (0, i)),
        ]
        args = [sphere128, np.asarray(planes)]
        if jdata is not None:
            cols = 128 if family == "maxplus" else 8
            full = np.zeros((script.NJ, cols), np.float32)
            full[:, :jdata.shape[1]] = jdata
            in_specs.append(pl.BlockSpec(full.shape, lambda i: (0, 0)))
            args.append(full)
            inner = kernel

            def kernel(sphere_ref, planes_ref, jd_ref, out_ref, *refs):
                proxy.jdata = jd_ref[...]
                inner(sphere_ref, planes_ref, out_ref, *refs)

        with pltpu.force_tpu_interpret_mode():
            fn = pl.pallas_call(
                kernel,
                grid=(script.T,),
                in_specs=in_specs,
                out_specs=pl.BlockSpec((1, script.A), lambda i: (0, i)),
                out_shape=jax.ShapeDtypeStruct((1, m), F32),
                scratch_shapes=scratch,
            )
            out = np.asarray(jax.jit(fn)(*args))
    finally:
        script.T, script.NJ, script.jnp = saved
    return out.reshape(-1)


def _case(variant, kind):
    """The port's (sphere, planes, jdata) for `variant` on j-data `kind`
    (NJ_MAXPLUS rows for max-plus) and the script's [P, 128] sphere."""
    sphere, planes, jd = ke.synthetic_inputs(T_SMALL, NJ_SMALL, "cpu", kind)
    if ke.VARIANTS[variant][0] == "maxplus":
        jd = ke.synthetic_inputs(T_SMALL, NJ_MAXPLUS, "cpu", kind)[2]
    sphere128 = np.random.default_rng(0).normal(size=(ke.P, 128)).astype(
        np.float32)
    return sphere, planes, jd, sphere128


# Roundings in one margin, on either side, with room to spare.
GAMMA = 16 * 2.0 ** -24


def _f64(x):
    return x.double().abs()


def _bound(variant, sphere, planes, jd, occ):
    """[T*A]: how far the script's sums may lie from the port's plain
    version.  Every margin is evaluated in at most 16 roundings on either
    side, each side within GAMMA of the sum of its terms' magnitudes; a
    maximum over j moves by at most the largest margin's move, and two
    sums of 128 points by those moves plus 2 * 127 * 2^-24 * sum |occ|.
    In the bf16 stream a limit that moves may round to the next bf16
    value and so may the margin.  DEFAULT's bf16 operands move each dot
    by at most (2 * 2^-8 + 2^-16) times the magnitude of its products.
    The groups the reach test leaves out are the same on both sides
    (_assert_votes_agree)."""
    family, params = ke.VARIANTS[variant]
    t = planes.shape[1] // ke.A
    nj = ke.jrows(variant, jd.shape[0])
    i = ke._i_tiles(planes, 0, t)
    j = ke._j_block(jd, 0, nj, params.get("noscalar", False))
    vx, vy, vz, v2, lim = ke._lim(i, j, params.get("gid", True))
    masked = lim == ke.NEG_BIG
    big = torch.where(masked, 0.0,
                      (_f64(j[5]) + _f64(v2) + _f64(i[5])) * _f64(i[6]))
    sx, sy, sz = (sphere[:, c].reshape(1, 1, ke.P, 1).double()
                  for c in range(3))
    if family == "maxplus":
        terms = (sx * j[0].double()).abs() + (sy * j[1].double()).abs() \
            + (sz * j[2].double()).abs()
    elif params.get("big") is False:
        terms = torch.zeros(1, dtype=torch.float64)
    else:
        terms = (sx * vx.double()).abs() + (sy * vy.double()).abs() \
            + (sz * vz.double()).abs()
    err = 2 * GAMMA * (big + terms)
    if params.get("default"):
        err = err + (2 * 2.0 ** -8 + 2.0 ** -16) * terms
    if family == "bf16":
        err = err + 2.0 ** -7 * _f64(lim) + 2.0 ** -6 * (_f64(lim) + terms)
    if params.get("skip"):
        err = ke._skip_mask(err, ke._hit(i, j, v2))
    per_point = err.amax(dim=1).clamp_min(0.0)  # [T, P, A] (or [T, 1, A])
    per_point = per_point.expand(t, ke.P, ke.A)
    return (per_point.sum(dim=1).reshape(-1)
            + 2 * 127 * 2.0 ** -24 * occ.double().abs().sum(dim=1).reshape(-1))


def _assert_votes_agree(variant, planes, jd):
    """Each group's reach vote, min over (row, atom) of v2 - (r_i + r_j)^2
    < 0, is decided by more than the rounding either side may make."""
    if not ke.VARIANTS[variant][1].get("skip"):
        return
    t = planes.shape[1] // ke.A
    nj = ke.jrows(variant, jd.shape[0])
    i = ke._i_tiles(planes, 0, t)
    j = ke._j_block(jd, 0, nj)
    _vx, _vy, _vz, v2, _lim = ke._lim(i, j)
    reach = i[3] + j[3]
    d = (v2 - reach * reach).double().reshape(t, -1, ke.GROUP, ke.A)
    err = 2 * GAMMA * (v2.double() + (reach * reach).double()).reshape(
        d.shape)
    surely_in = (d < -err).any(dim=-1).any(dim=-1)
    surely_out = (d > err).all(dim=-1).all(dim=-1)
    assert bool((surely_in | surely_out).all())
    assert 0 < int(surely_out.sum()) or bool((jd == 1).all())


def _assert_within(got, want, bound):
    diff = (got.double() - torch.from_numpy(want.copy()).double()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((diff <= bound).all()), float((diff - bound).max())


@pytest.mark.parametrize("kind", ["ones", "random"])
@pytest.mark.parametrize("variant", list(ke.VARIANTS))
def test_variant_matches_script(script, variant, kind):
    sphere, planes, jd, sphere128 = _case(variant, kind)
    want = _script_sums(script, variant, planes, sphere128,
                        jdata=None if kind == "ones" else jd.numpy())
    got, executed = ke.experiment(variant, sphere, planes, jd)
    groups = ke.jrows(variant, jd.shape[0]) // ke.GROUP
    assert executed.shape == (T_SMALL,)
    assert int(executed.min()) >= 0 and int(executed.max()) <= groups
    if not ke.VARIANTS[variant][1].get("skip"):
        assert executed.tolist() == [groups] * T_SMALL
    _assert_votes_agree(variant, planes, jd)
    occ, _ = ke.plain_occ(variant, sphere, planes, jd)
    _assert_within(got, want, _bound(variant, sphere, planes, jd, occ))
    if ke.VARIANTS[variant][0] == "bf16":
        # Rounding to bf16 after every op leaves XLA nothing to contract.
        np.testing.assert_array_equal(got.numpy(), want)
    if ke.VARIANTS[variant][1].get("default"):
        # XLA-CPU computes DEFAULT in full f32, as HIGHEST; the port's
        # bf16 operands really change the sums.
        hi = variant.replace("_def", "_hi")
        want_hi = _script_sums(script, hi, planes, sphere128,
                               jdata=None if kind == "ones" else jd.numpy())
        np.testing.assert_array_equal(want_hi, want)
        hi_got, _ = ke.experiment(hi, sphere, planes, jd)
        assert int((got != hi_got).sum()) > 0


def _groups_in_reach(variant, planes, jd):
    """[T]: the 8-row groups of each tile that some (row, atom) pair
    reaches, v2 < (r_i + r_j)^2 in float64."""
    t = planes.shape[1] // ke.A
    nj = ke.jrows(variant, jd.shape[0])
    p = planes.double().numpy()
    j = jd[:nj].double().numpy()
    counts = []
    for tile in range(t):
        ci = p[:3, tile * ke.A:(tile + 1) * ke.A]  # [3, A]
        v2 = ((ci[:, None, :] - j[:, :3].T[:, :, None]) ** 2).sum(axis=0)
        reach = p[3, tile * ke.A:(tile + 1) * ke.A][None] + j[:, 3:4]
        hit = (v2 < reach * reach).reshape(nj // ke.GROUP, -1).any(axis=1)
        counts.append(int(hit.sum()))
    return counts


@pytest.mark.parametrize("variant", ["mp_tile_hi_skip", "g8_bf16_skip"])
def test_skip_variants_match_script_on_far_groups(script, variant):
    """The far j-data: the first and last 8-row group of each j-tile lie
    out of every atom's reach, and the last i-tile out of every group's.
    The plain version's sums match the script's, and its executed groups
    are those the reach test admits: none for the far tile."""
    sphere, planes, jd, sphere128 = _case(variant, "far")
    want = _script_sums(script, variant, planes, sphere128, jdata=jd.numpy())
    got, executed = ke.experiment(variant, sphere, planes, jd)
    _assert_votes_agree(variant, planes, jd)
    groups = ke.jrows(variant, jd.shape[0]) // ke.GROUP
    assert executed.tolist() == _groups_in_reach(variant, planes, jd)
    assert int(executed[-1]) == 0 and int(executed[0]) <= groups - 2
    occ, _ = ke.plain_occ(variant, sphere, planes, jd)
    _assert_within(got, want, _bound(variant, sphere, planes, jd, occ))
    if ke.VARIANTS[variant][0] == "bf16":
        np.testing.assert_array_equal(got.numpy(), want)


# Each family's operations per margin: (variant, operations, margins they
# cover).  bf16 rounds after every op, so its 7 packed ops take no
# multiply-add; the tensor cores take the DEFAULT dots' products.  nobig's
# margin is its limit, shared by all P points: one limit chain (v, v2, the
# limit, the gid mask's compare folded with the row's gk == 0 and its
# select) and one max cover a pair's P margins.
OPS = {
    "full": (["mul"] * 3 + ["add"] * 2 + ["sub", "max"], 1),
    "nobig": (["sub"] * 3 + ["mul"] * 3 + ["add"] * 2 + ["sub"] * 2
              + ["mul"] + ["cmp_or", "sel", "max"], ke.P),
    "mp_tile_hi": (["add", "max"], 1),
    "g8_bf16": (["mul"] * 3 + ["add"] * 2 + ["sub", "max"], 2),
    "mxu_dots_hi": (["mul", "fma", "fma", "sub", "max"], 1),
    "mxu_dots_def": (["sub", "max"], 1),
}


@pytest.mark.parametrize("variant", list(OPS))
def test_instr_per_margin_counts_each_familys_ops(variant):
    ops, margins = OPS[variant]
    assert ke.instr_per_margin(variant) == len(ops) / margins


def _in_order_sum_of_copies(x, n):
    """n copies of x [t, A] added in order, as point_sum adds P points."""
    acc = x
    for _ in range(1, n):
        acc = acc + x
    return acc.reshape(-1)


@pytest.mark.parametrize("kind", ["ones", "random", "far"])
def test_nobig_is_the_sum_of_copies_of_each_atoms_max_limit(kind):
    """The fold csrc/ke_stream.cu's nobig kernel does: its plain version
    equals, bit for bit, 128 in-order copies of max(-1e30, max_j lim) per
    atom, with the j-rows folded in any split (here: all at once, and
    two halves met with a max)."""
    t, nj = 3, 48
    sphere, planes, jd = ke.synthetic_inputs(t, nj, "cpu", kind)
    want, executed = ke.experiment_reference(planes, "nobig", sphere, jd)
    i = ke._i_tiles(planes, 0, t)
    lim = ke._lim(i, ke._j_block(jd, 0, nj))[4]  # [t, nj, 1, A]
    m_a = torch.clamp_min(lim.amax(dim=1)[:, 0], ke.NEG_BIG)
    halves = torch.maximum(lim[:, :nj // 2].amax(dim=1),
                           lim[:, nj // 2:].amax(dim=1))[:, 0]
    assert torch.equal(torch.clamp_min(halves, ke.NEG_BIG), m_a)
    assert torch.equal(_in_order_sum_of_copies(m_a, ke.P), want)
    assert executed.tolist() == [nj // ke.GROUP] * t
    if kind == "random":
        assert bool((lim == ke.NEG_BIG).any())  # the gid mask fires


@pytest.mark.parametrize("kind", ["ones", "random", "far"])
def test_noscalar_is_one_constant_row(kind):
    """The fold csrc/ke_stream.cu's noscalar kernel does: the output does
    not depend on how many copies of its constant j-row there are (nj =
    8 and the script's 1,408), and equals that one row's margins,
    max(-1e30, lim - dots), summed over the points in order."""
    t = 2
    sphere, planes, jd = ke.synthetic_inputs(t, ke.NJ, "cpu", kind)
    sums = []
    for nj in (8, ke.NJ):
        got, executed = ke.experiment_reference(planes, "noscalar", sphere,
                                                jd[:nj])
        assert executed.tolist() == [nj // ke.GROUP] * t
        sums.append(got)
    assert torch.equal(sums[0], sums[1])
    i = ke._i_tiles(planes, 0, t)
    vx, vy, vz, _v2, lim = ke._lim(i, ke._j_block(jd, 0, 1, noscalar=True))
    sx, sy, sz = (sphere[:, c].reshape(1, 1, ke.P, 1) for c in range(3))
    m = lim - (sx * vx + (sy * vy + sz * vz))  # [t, 1, P, A]
    occ = torch.clamp_min(m[:, 0], ke.NEG_BIG)
    assert torch.equal(ke.point_sum(occ), sums[0])


def test_sass_mix_finds_innermost_loops():
    """scripts/sass_mix.py's reading of cuobjdump -sass: functions,
    predicated branches back to a loop head, and the trailing self-branch
    every kernel ends with."""
    from rustsasa_tpu_torch.scripts import sass_mix

    text = """
\tcode for sm_90a
\t\tFunction : _Z3fooPf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
        /*0010*/                   MOV R2, RZ ;                /* 0x000000ff00027202 */
        /*0020*/                   LDS.128 R4, [R3] ;          /* 0x0000000003047984 */
        /*0030*/                   FADD R5, R4, R6 ;           /* 0x0000000604057221 */
        /*0040*/                   FMNMX R7, R7, R5, !PT ;     /* 0x0000000507077209 */
        /*0050*/              @!P0 BRA 0x20 ;                  /* 0xfffffffc00008947 */
        /*0060*/                   EXIT ;                      /* 0x000000000000794d */
        /*0070*/                   BRA 0x70;                   /* 0xfffffffc00fc7947 */
\t\tFunction : _Z3barv
        /*0000*/                   EXIT ;                      /* 0x000000000000794d */
"""
    functions = sass_mix.parse(text)
    assert list(functions) == ["_Z3fooPf", "_Z3barv"]
    code = functions["_Z3fooPf"]
    assert len(code) == 8 and code[5] == (0x50, "@!P0 BRA 0x20")
    assert sass_mix.opcode(code[5][1]) == "BRA"
    assert sass_mix.opcode(code[2][1]) == "LDS.128"
    assert sass_mix.innermost_loops(code) == [(2, 5), (7, 7)]
    assert sass_mix.mix(code, 2, 5) == {"LDS.128": 1, "FADD": 1, "FMNMX": 1,
                                        "BRA": 1}
    assert sass_mix.innermost_loops(functions["_Z3barv"]) == []


@pytest.mark.parametrize("variant", ["full", "group8", "g8_fma_skip",
                                     "mp_tile_hi", "g8_bf16", "mxu_dots_hi"])
def test_family_matches_unpatched_script(script, variant):
    """One variant per make_* function against the script's own jnp.sum,
    whose order is not the port's: the same bound, whose summation term
    covers any order of 128 additions."""
    sphere, planes, jd, sphere128 = _case(variant, "ones")
    want = _script_sums(script, variant, planes, sphere128, sequential=False)
    got, _ = ke.experiment(variant, sphere, planes, jd)
    occ, _ = ke.plain_occ(variant, sphere, planes, jd)
    _assert_within(got, want, _bound(variant, sphere, planes, jd, occ))
    seq = _script_sums(script, variant, planes, sphere128)
    assert int((seq != want).sum()) > 0 or variant == "g8_bf16"


def _full_as_xla_cpu_contracts(sphere, planes, jd):
    """`full` with the fused multiply-adds XLA-CPU forms in its loop:
    v2 = fma(vz, vz, fma(vy, vy, vx*vx)), dots = fma(sx, vx, fma(sy, vy,
    sz*vz))."""
    i = ke._i_tiles(planes, 0, planes.shape[1] // ke.A)
    j = ke._j_block(jd, 0, jd.shape[0])
    xi, yi, zi, _ri, gi, r2i, inv2ri = i
    xk, yk, zk, _rk, gk, rr = j
    vx, vy, vz = xi - xk, yi - yk, zi - zk
    v2 = fma_f32(vz, vz, fma_f32(vy, vy, vx * vx))
    lim = ((rr - v2) - r2i) * inv2ri
    lim = torch.where((gi == gk) | (gk == 0.0), ke.NEG_BIG, lim)
    sx, sy, sz = (sphere[:, c].reshape(1, 1, ke.P, 1) for c in range(3))
    dots = fma_f32(sx, vx, fma_f32(sy, vy, sz * vz))
    occ = torch.maximum(torch.full((vx.shape[0], ke.P, ke.A), ke.NEG_BIG),
                        (lim - dots).amax(dim=1))
    return ke.point_sum(occ).numpy()


@pytest.mark.parametrize("kind", ["ones", "random"])
def test_xla_cpu_contracts_the_script_kernels(script, kind):
    """What XLA-CPU computes for `full` in interpret mode: the script's
    arithmetic with two multiply-add chains fused, byte for byte; the
    port's separately rounded version differs."""
    sphere, planes, jd, sphere128 = _case("full", kind)
    want = _script_sums(script, "full", planes, sphere128,
                        jdata=None if kind == "ones" else jd.numpy())
    np.testing.assert_array_equal(
        _full_as_xla_cpu_contracts(sphere, planes, jd), want)
    got, _ = ke.experiment("full", sphere, planes, jd)
    assert int((got.numpy() != want).sum()) > 5


def test_xla_cpu_sum_order_is_not_sequential_and_the_proxy_is():
    x = (np.random.default_rng(11).normal(size=(128, 128)) * 1e3).astype(
        np.float32)
    xla = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0))(x))
    seq = ke.point_sum(torch.from_numpy(x)[None]).numpy()
    assert int((xla != seq).sum()) > 50
    proxy = np.asarray(jax.jit(
        lambda a: SequentialJnp().sum(a, axis=0, keepdims=True))(x))
    np.testing.assert_array_equal(proxy.reshape(-1), seq)


HI = jax.lax.Precision.HIGHEST
DEF = jax.lax.Precision.DEFAULT


def _dot(x, y, dims, precision):
    return np.asarray(jax.jit(lambda a, b: jax.lax.dot_general(
        a, b, (dims, ((), ())), precision=precision,
        preferred_element_type=jnp.float32))(x, y))


@pytest.mark.parametrize("k", [8, 128])
def test_zero_padded_dots_are_dot3_chains_on_xla_cpu(k):
    """The script's [P, 8] x [8, A] (mxu, per-group max-plus) and
    [P, 128] x [128 j, 128 c] (per-tile max-plus) products at HIGHEST
    equal fma(s2, v2, fma(s1, v1, s0 * v0)) at every element."""
    rng = np.random.default_rng(k)
    s = rng.normal(size=(128, k)).astype(np.float32)
    s[:, 3:] = 0.0
    v = (rng.normal(size=(128, k)) * 7).astype(np.float32)  # [j or a, k]
    if k == 8:
        got = _dot(s, np.ascontiguousarray(v.T), ((1,), (0,)), HI)
    else:
        got = _dot(s, v, ((1,), (1,)), HI)
    st = torch.from_numpy(s)[:, None, :]
    vt = torch.from_numpy(v)[None]
    want = dot3(st[..., 0], vt[..., 0], st[..., 1], vt[..., 1], st[..., 2],
                vt[..., 2])
    np.testing.assert_array_equal(got, want.numpy())
    plain = (st[..., 0] * vt[..., 0] + st[..., 1] * vt[..., 1]) \
        + st[..., 2] * vt[..., 2]
    assert int((plain.numpy() != got).sum()) > 100


def test_default_precision_is_full_f32_on_xla_cpu():
    """What a TPU runs as one bf16 pass, XLA-CPU computes in full f32:
    DEFAULT and HIGHEST are bit-identical there, and differ from the
    product of bf16-rounded operands."""
    rng = np.random.default_rng(3)
    s = rng.normal(size=(128, 8)).astype(np.float32)
    v = rng.normal(size=(8, 128)).astype(np.float32)
    hi = _dot(s, v, ((1,), (0,)), HI)
    np.testing.assert_array_equal(_dot(s, v, ((1,), (0,)), DEF), hi)
    s16 = torch.from_numpy(s).to(torch.bfloat16).double()
    v16 = torch.from_numpy(v).to(torch.bfloat16).double()
    assert int(((s16 @ v16).float().numpy() != hi).sum()) > 10000


def test_bf16_stream_rounds_after_every_op(script):
    """make_bf16_kernel's [P, A] stream rounds to bf16 after each multiply,
    add, subtract (the port's plain version, byte-equal to the script in
    test_variant_byte_equal_script); rounding once per margin differs."""
    sphere, planes, jd, sphere128 = _case("g8_bf16", "random")
    want = _script_sums(script, "g8_bf16", planes, sphere128,
                        jdata=jd.numpy())
    bf = torch.bfloat16
    i = ke._i_tiles(planes, 0, T_SMALL)
    j = ke._j_block(jd, 0, jd.shape[0])
    vx, vy, vz, _v2, lim = ke._lim(i, j)
    s = [sphere[:, c].reshape(1, 1, ke.P, 1).to(bf).float() for c in range(3)]
    r = [x.to(bf).float() for x in (vx, vy, vz, lim)]
    once = (r[3] - (s[0] * r[0] + (s[1] * r[1] + s[2] * r[2]))).to(bf)
    occ = torch.maximum(torch.full((T_SMALL, ke.P, ke.A), ke.NEG_BIG,
                                   dtype=bf), once.amax(dim=1))
    rounded_once = ke.point_sum(occ.float()).numpy()
    assert int((rounded_once != want).sum()) > 10
    got, _ = ke.experiment("g8_bf16", sphere, planes, jd)
    np.testing.assert_array_equal(got.numpy(), want)


def test_synthetic_inputs():
    sphere, planes, jd = ke.synthetic_inputs(3, 16, "cpu")
    assert sphere.shape == (ke.P, 4) and planes.shape == (8, 3 * ke.A)
    assert bool((sphere[:, 3] == 0).all()) and bool((jd == 1).all())
    want = np.random.default_rng(1).normal(size=(8, 3 * ke.A)).astype(
        np.float32)
    np.testing.assert_array_equal(planes.numpy(), want)
    _s, planes_r, jr = ke.synthetic_inputs(3, 16, "cpu", "random")
    assert jr.shape == (16, 8) and bool((jr[:, 5:] == 0).all())
    for gids in (jr[:, 4], planes_r[4]):
        assert bool((gids == gids.round()).all())
        assert 0 <= float(gids.min()) and float(gids.max()) <= 7
    assert bool((jr[:, 3] >= 1).all()) and bool((jr[:, 3] < 3).all())
    with pytest.raises(ValueError, match="jdata"):
        ke.synthetic_inputs(1, 8, "cpu", "zeros")


def test_experiment_refuses_other_devices_and_missing_card(monkeypatch):
    sphere, planes, jd = ke.synthetic_inputs(1, 8, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        ke.experiment("full", sphere, planes.to("meta"), jd)
    with pytest.raises(ValueError, match="unknown variant"):
        ke.experiment("g16", sphere, planes, jd)
    for src in _kernels.KE_VARIANTS:
        with pytest.raises(ValueError, match="CUDA"):
            _kernels.kernel_experiment(src, _kernels.KE_VARIANTS[src][0],
                                       sphere, planes, jd)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ke.run("cuda", t=1, nj=8)
    assert ke.main([]) == 1


def test_run_on_cpu():
    result = ke.run("cpu", t=T_SMALL, nj=NJ_SMALL, reps=1)
    assert result["t"] == T_SMALL and result["nj"] == NJ_SMALL
    variants = result["variants"]
    assert list(variants) == list(ke.VARIANTS)
    for name, v in variants.items():
        assert v["ms"] > 0 and v["ns_per_jatom"] > 0
        assert v["executed"] <= v["groups"]
        if name == "noscalar":  # one constant j-row
            assert v["margins"] == T_SMALL * ke.P * ke.A
        else:
            assert v["margins"] == v["executed"] * ke.GROUP * ke.P * ke.A
        if ke.VARIANTS[name][0] == "maxplus":
            assert v["groups"] == 0  # NJ // 128 = 0 j-tiles, as the script
        else:
            assert v["groups"] == T_SMALL * NJ_SMALL // ke.GROUP
    for name, (ops, margins) in OPS.items():
        assert variants[name]["instr_per_margin"] == len(ops) / margins


def test_mxu_overlap_cuts_apply_to_the_kernel_source():
    """scripts/mxu_overlap.py times ke_mxu.cu with its tensor-core or its
    CUDA-core work cut out; each cut must find its text exactly once."""
    from rustsasa_tpu_torch.scripts import mxu_overlap

    with open(mxu_overlap.SOURCE, encoding="utf-8") as f:
        text = f.read()
    assert [tag for tag, _ in mxu_overlap.CUTS] == [
        "full", "cuda_cores", "tensor_cores", "unread"]
    for _tag, subs in mxu_overlap.CUTS:
        for old, _new in subs:
            assert text.count(old) == 1


def test_loop_ceiling_cuts_apply_to_the_kernel_sources():
    """scripts/loop_ceiling.py times ke_maxplus.cu and ke_bf16.cu with
    their barriers or prologues cut out; each cut must find its text
    exactly once, and the first build is the source as it is."""
    from rustsasa_tpu_torch.scripts import loop_ceiling

    assert set(loop_ceiling.CUTS) == set(loop_ceiling.CUT_VARIANTS)
    for name, cuts in loop_ceiling.CUTS.items():
        sources = _kernels.cut_sources(name, cuts)
        assert list(sources) == ["full", "nobar", "noprologue"]
        with open(f"{_kernels.CSRC_DIR}/{name}.cu", encoding="utf-8") as f:
            assert sources["full"] == f.read()
        assert len(set(sources.values())) == len(cuts)
        for variant in loop_ceiling.CUT_VARIANTS[name]:
            assert ke.source(variant) == name


def test_layout_probe_cuts_apply_to_the_kernel_sources():
    """scripts/layout_probe.py times list_occlusion.cu with other records
    a thread and points a loop step, and without its barriers or loads,
    and neighbor_cells.cu with other rows a CTA and register caps, and
    without its stores, steps or scan, and its cell_keys without the
    ordering or parts of it; each cut must find its text exactly once,
    and the first build is the source as it is."""
    from rustsasa_tpu_torch.scripts import layout_probe

    for name, cuts in (*layout_probe.CUTS.items(),
                       ("neighbor_cells", layout_probe.KEYS_CUTS)):
        sources = _kernels.cut_sources(name, cuts)
        assert list(sources) == [tag for tag, _ in cuts]
        with open(f"{_kernels.CSRC_DIR}/{name}.cu", encoding="utf-8") as f:
            assert next(iter(sources.values())) == f.read()
        assert len(set(sources.values())) == len(cuts)
