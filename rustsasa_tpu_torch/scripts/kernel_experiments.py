"""The fused-kernel cost study on synthetic data, on the card.

Port of `scripts/kernel_experiments.py`:

    python -m rustsasa_tpu_torch.scripts.kernel_experiments

Every variant computes, per i-atom of T tiles of A = 128 atoms, the sum
over P = 128 sphere points of the largest margin over NJ = 1,408 j-atoms
that stay resident on the chip (no j-list):

    out[i] = sum_p max_j margin(p, i, j),   starting from -1e30,
    margin = lim_ij - s_p.(c_i - c_j)        (f32 stream, bf16, mxu dots)
    margin = s_p.c_j + lim_ij                (max-plus: no s_p.c_i term)
    lim_ij = ((r_j*r_j - |c_i - c_j|^2) - r_i*r_i) * (0.5 / max(r_i, 1e-6)),

with lim = -1e30 where gid_i == gid_j or gid_j == 0.  One call is
T*NJ*P*A = 11,811,160,064 margins.  The variants are the script's own,
by its names (VARIANTS); `group8_smem` is `make_grouped_kernel(8, True)`,
which the script supports but never names.  They differ in how the
margin is computed (FMA order, bf16, products on the tensor cores), in
where the j-rows and the sphere are read from, and in a per-group reach
test (`skip`) that leaves out 8-row groups no i-atom of the tile can
reach; four CUDA sources in `ops/csrc/` (ke_stream, ke_maxplus, ke_bf16,
ke_mxu) hold them.

The sphere and planes are the script's: numpy's default_rng(0) and (1)
normals.  The j-data is the script's ones, or a seeded random set
(`synthetic_inputs(jdata="random")`) on which the gid mask and the reach
test fire.  Each variant's plain-torch version repeats the script's
arithmetic as XLA-CPU computes it (products at HIGHEST as the fused chain
fma(a2, b2, fma(a1, b1, a0*b0)), bf16 rounded after every op), and sums
the points in order p = 0..127; at DEFAULT precision it rounds the dot
operands to bf16, as a bf16 matrix unit does.  `run` times every kernel
with CUDA events and reports ns per j-atom (the script's metric) and the
FP32 instruction rate at the variant's own work.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import _kernels
from ..ops import fused_kernel as fk
from ..ops.fma import dot3
from . import _study

A = 128
P = 128
NJ = 1408
T = 512
GROUP = 8
NEG_BIG = -1e30
# Random j-data: coordinates are normals times this spread, so that some
# 8-row groups lie out of every i-atom's reach.
RANDOM_SPREAD = 8.0
# Far j-data: the groups and the i-tile moved this far (in Angstrom) lie
# out of reach of everything else.
FAR = 1.0e3

# name -> (family, parameters).  Families: "stream" (make_kernel,
# make_grouped_kernel, make_v2_kernel), "maxplus" (make_v3_kernel), "bf16"
# (make_bf16_kernel), "mxu" (make_mxu_dots_kernel).
VARIANTS = {
    "full": ("stream", {}),
    "noscalar": ("stream", {"noscalar": True}),
    "nogid": ("stream", {"gid": False}),
    "nobig": ("stream", {"big": False}),
    "group8": ("stream", {}),
    "group8_smem": ("stream", {}),
    "g8": ("stream", {}),
    "g8_fma": ("stream", {"fma": True}),
    "g8_fma_skip": ("stream", {"fma": True, "skip": True}),
    "g8_hoist": ("stream", {}),
    "g8_hoist_skip": ("stream", {"skip": True}),
    "mp_tile_hi": ("maxplus", {}),
    "mp_tile_def": ("maxplus", {"default": True}),
    "mp_tile_hi_skip": ("maxplus", {"skip": True}),
    "mp_group_hi": ("maxplus", {}),
    "mp_group_def": ("maxplus", {"default": True}),
    "mp_tile_hi_sat": ("maxplus", {"sat": True}),
    "g8_bf16": ("bf16", {}),
    "g8_bf16_skip": ("bf16", {"skip": True}),
    "mxu_dots_hi": ("mxu", {}),
    "mxu_dots_def": ("mxu", {"default": True}),
    "mxu_dots_hi_skip": ("mxu", {"skip": True}),
}
# FP32 instructions per margin at each family's own work: the f32 stream
# 3 mul, 2 add (or 3 sub), 1 sub, 1 max; max-plus add, max; the mxu dots
# on CUDA cores mul, 2 fma, sub, max; on the tensor cores sub, max; bf16 7
# packed instructions per 2 margins (3 mul, 2 add, 1 sub, 1 max: it
# rounds after every op, so no multiply-add).
_INSTR = {"stream": 7, "maxplus": 2, "bf16": 3.5, "mxu": 5}
# nobig's margin is its limit, which all P points share: its work is the
# limit and one max per (atom, j-row) pair, as the SASS of its row loop
# (csrc/ke_stream.cu ke_nobig_kernel, scripts/sass_mix.py: 65
# instructions for 1 row x 4 atoms, 9 of them the row's loads and loop
# work) counts them: v 3 sub, v2 3 mul and 2 add, the limit 2 sub and 1
# mul, the gid mask a compare (FSETP.EQ.OR with the row's gk == 0) and a
# select, and the max.
NOBIG_INSTR_PER_PAIR = 14


def instr_per_margin(variant: str) -> float:
    family, params = VARIANTS[variant]
    if params.get("big") is False:
        return NOBIG_INSTR_PER_PAIR / P
    if family == "mxu" and params.get("default"):
        return 2
    return _INSTR[family]


def source(variant: str) -> str:
    """The kernel source (csrc/<name>.cu) that runs `variant`."""
    return "ke_" + VARIANTS[variant][0]


def jrows(variant: str, nj: int) -> int:
    """The j-rows a variant streams: the max-plus loop runs nj // 128
    whole j-tiles, the others every row."""
    return nj // A * A if VARIANTS[variant][0] == "maxplus" else nj


def synthetic_inputs(t: int = T, nj: int = NJ, device="cpu", jdata="ones",
                     seed: int = 7):
    """(sphere [P, 4] f32 (x, y, z, 0), planes [8, t*A] f32, jdata [nj, 8]
    f32) on `device`.

    The sphere and planes are the script's (default_rng(0) and (1)
    normals; rows 0-4 of the planes are x, y, z, r_eff, gid).  jdata
    "ones" is the script's resident j-data; "random" draws, from `seed`,
    coordinates as normals times RANDOM_SPREAD, radii uniform in [1, 3)
    and integer gids 0-7 (columns 0-4; 5-7 are zero), and sets plane row 4
    to integer gids 0-7, so that the gid mask and the reach test fire.
    "far" is "random" with the first and last 8-row group of each 128-row
    j-tile (of the last, partial one too) moved FAR along x, y and z, and
    the last i-tile moved FAR the other way, so that the reach test leaves
    out those groups everywhere and every group for that tile.
    """
    m = t * A
    sphere128 = np.random.default_rng(0).normal(size=(P, 128)).astype(np.float32)
    sphere = np.zeros((P, 4), np.float32)
    sphere[:, :3] = sphere128[:, :3]
    planes = np.random.default_rng(1).normal(size=(8, m)).astype(np.float32)
    if jdata == "ones":
        jd = np.ones((nj, 8), np.float32)
    elif jdata in ("random", "far"):
        rng = np.random.default_rng(seed)
        jd = np.zeros((nj, 8), np.float32)
        jd[:, :3] = rng.normal(size=(nj, 3)) * RANDOM_SPREAD
        jd[:, 3] = rng.uniform(1.0, 3.0, nj)
        jd[:, 4] = rng.integers(0, 8, nj)
        planes[4] = rng.integers(0, 8, m)
        if jdata == "far":
            for j0 in range(0, nj, A):
                j1 = min(nj, j0 + A)
                jd[j0:j0 + GROUP, :3] += FAR
                jd[j1 - GROUP:j1, :3] += FAR
            planes[:3, m - A:] -= FAR
    else:
        raise ValueError(
            f"jdata {jdata!r}: expected 'ones', 'random' or 'far'")
    return tuple(torch.from_numpy(x).to(device) for x in (sphere, planes, jd))


def _block_tiles(dev, t, jc):
    elems = fk.REFERENCE_BLOCK_ELEMS[dev.type]
    return max(1, min(t, elems // (jc * P * A)))


def _i_tiles(planes, t0, t1):
    """Per-tile i-atom rows [B, 1, 1, A]: x, y, z, r, gid, r*r, 0.5/max(r,
    1e-6)."""
    xi, yi, zi, ri, gi = (planes[row, t0 * A:t1 * A].reshape(t1 - t0, 1, 1, A)
                          for row in range(5))
    # Tensor / tensor: `0.5 / x` would run as reciprocal(x) * 0.5.
    inv2ri = torch.full_like(ri, 0.5) / torch.clamp_min(ri, 1e-6)
    return xi, yi, zi, ri, gi, ri * ri, inv2ri


def _j_block(jdata, j0, j1, noscalar=False):
    """j-rows j0..j1 as [1, J, 1, 1] columns x, y, z, r, gid and r*r."""
    dev = jdata.device
    if noscalar:
        # The script's Python constants: r*r is 3.1 * 3.1 in double,
        # rounded once to f32.
        vals = [torch.full((1, j1 - j0, 1, 1), v, dtype=torch.float32,
                           device=dev)
                for v in (1.0, 2.0, 3.0, 3.1, 7.0, np.float32(3.1 * 3.1))]
        return tuple(vals)
    xk, yk, zk, rk, gk = (jdata[j0:j1, c].reshape(1, -1, 1, 1)
                          for c in range(5))
    return xk, yk, zk, rk, gk, rk * rk


def _lim(i, j, gid=True):
    """(vx, vy, vz, v2, lim) [B, J, 1, A] in the script's order."""
    xi, yi, zi, _ri, gi, r2i, inv2ri = i
    xk, yk, zk, _rk, gk, rr = j
    vx, vy, vz = xi - xk, yi - yk, zi - zk
    v2 = (vx * vx + vy * vy) + vz * vz
    lim = ((rr - v2) - r2i) * inv2ri
    if gid:
        lim = torch.where((gi == gk) | (gk == 0.0), NEG_BIG, lim)
    return vx, vy, vz, v2, lim


def _hit(i, j, v2):
    """[B, J // 8] bool: the reach test of each 8-row group,
    min over rows and atoms of (v2 - (r_i + r_j)^2) < 0."""
    reach = i[3] + j[3]
    d = v2 - reach * reach  # [B, J, 1, A]
    b = d.shape[0]
    return (d.reshape(b, -1, GROUP, A) < 0.0).any(dim=-1).any(dim=-1)


def _skip_mask(m, hit):
    """-inf for the margins of groups the reach test leaves out."""
    keep = hit.repeat_interleave(GROUP, dim=1)[:, :, None, None]
    return torch.where(keep, m, float("-inf"))


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def plain_occ(variant, sphere, planes, jdata):
    """Plain-torch version of `variant` before its point sum -> (occ
    [t, P, A] f32 (bf16 values for the bf16 family), executed [t] i32:
    the 8-row groups each tile ran)."""
    family, params = VARIANTS[variant]
    dev = planes.device
    t = planes.shape[1] // A
    nj = jrows(variant, jdata.shape[0])
    sx, sy, sz = (sphere[:, c].reshape(1, 1, P, 1) for c in range(3))
    if params.get("default"):
        sx, sy, sz = _bf16(sx), _bf16(sy), _bf16(sz)
    bf16 = family == "bf16"
    dt = torch.bfloat16 if bf16 else torch.float32
    if bf16:
        s16 = tuple(s.to(torch.bfloat16) for s in (sx, sy, sz))
    skip = params.get("skip", False)
    jc = A if family == "maxplus" else 32
    occ_all = torch.empty((t, P, A), dtype=torch.float32, device=dev)
    executed = torch.zeros(t, dtype=torch.int32, device=dev)
    bt = _block_tiles(dev, t, jc)
    for t0 in range(0, t, bt):
        t1 = min(t, t0 + bt)
        i = _i_tiles(planes, t0, t1)
        occ = torch.full((t1 - t0, P, A), NEG_BIG, dtype=dt, device=dev)
        if params.get("sat"):
            ci = tuple(c.reshape(t1 - t0, 1, A) for c in i[:3])
            sxi = dot3(sx[0], ci[0], sy[0], ci[1], sz[0], ci[2])  # [B, P, A]
        for j0 in range(0, nj, jc):
            j1 = min(nj, j0 + jc)
            j = _j_block(jdata, j0, j1, params.get("noscalar", False))
            vx, vy, vz, v2, lim = _lim(i, j, params.get("gid", True))
            if family == "stream":
                if params.get("big") is False:
                    m = lim
                elif params.get("fma"):
                    m = ((lim - sx * vx) - sy * vy) - sz * vz
                else:
                    m = lim - (sx * vx + (sy * vy + sz * vz))
            elif family == "mxu":
                if params.get("default"):
                    dots = (sx * _bf16(vx) + sy * _bf16(vy)) + sz * _bf16(vz)
                else:
                    dots = dot3(sx, vx, sy, vy, sz, vz)
                m = lim - dots
            elif family == "maxplus":
                xk, yk, zk = (j[c] for c in range(3))
                if params.get("default"):
                    sxj = (sx * _bf16(xk) + sy * _bf16(yk)) + sz * _bf16(zk)
                else:
                    sxj = dot3(sx, xk, sy, yk, sz, zk)  # [1, J, P, 1]
                m = sxj + lim
            else:
                dots = s16[0] * vx.to(dt) + (s16[1] * vy.to(dt)
                                             + s16[2] * vz.to(dt))
                m = lim.to(dt) - dots
            if skip:
                hit = _hit(i, j, v2)
                m = _skip_mask(m, hit)
                executed[t0:t1] += hit.sum(dim=1, dtype=torch.int32)
            occ = torch.maximum(occ, m.amax(dim=1))
            if params.get("sat"):
                # The script's never-firing test, once per j-tile.
                fire = (occ - sxi).amin(dim=(1, 2)) > 1e30
                occ = torch.where(fire[:, None, None], occ - 1.0, occ)
        if not skip:
            executed[t0:t1] = nj // GROUP
        occ_all[t0:t1] = occ.to(torch.float32)
    return occ_all, executed


def point_sum(occ):
    """[t, P, A] -> [t*A]: the sum over points in order p = 0..127."""
    acc = occ[:, 0]
    for p in range(1, occ.shape[1]):
        acc = acc + occ[:, p]
    return acc.reshape(-1)


def experiment_reference(planes, variant, sphere, jdata):
    """Plain-torch version of `experiment`."""
    occ, executed = plain_occ(variant, sphere, planes, jdata)
    return point_sum(occ), executed


def experiment_kernel(planes, variant, sphere, jdata):
    """The CUDA kernel of `experiment` (csrc/<source(variant)>.cu)."""
    return _kernels.kernel_experiment(source(variant), variant, sphere,
                                      planes, jdata)


def experiment(variant, sphere, planes, jdata):
    """(sums [t*A] f32, executed [t] i32) of `variant` on synthetic
    inputs (`synthetic_inputs`): the plain version for CPU tensors, the
    variant's CUDA kernel for CUDA tensors, any other device refused."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    return fk.on_device(experiment_reference, experiment_kernel, planes,
                        variant, sphere, jdata)


def default_bound(variant, sphere, planes, jdata, occ):
    """[t*A] f32: how far a DEFAULT-precision variant's kernel sum may lie
    from its plain version.  Both round the dot operands to bf16, so every
    product is exact; the tensor core adds the three products in its own
    order and precision, at most 4 ulp of the sum of their magnitudes
    (2^-22 * S) away from the plain version's two roundings.  A margin then
    moves by that plus one rounding (2^-23 |occ|), and the point sum by the
    margins' moves plus two summations' rounding (2 * 127 * 2^-24 *
    sum_p |occ|)."""
    family = VARIANTS[variant][0]
    s_abs = _bf16(sphere[:, :3]).abs().sum(dim=1).max()
    c_j = _bf16(jdata[:jrows(variant, jdata.shape[0]), :3]).abs().amax(dim=0)
    if family == "mxu":
        c_i = planes[:3].abs().amax(dim=1)
        c_j = _bf16(c_i + c_j)
    s = float(s_abs) * float(c_j.max())
    mag = occ.abs().sum(dim=1).reshape(-1)
    return P * 2.0 ** -22 * s + (2.0 ** -23 + 2 * 127 * 2.0 ** -24) * mag


def agreement(variant, sphere, planes, jdata, got, want):
    """(max |difference| of the sums, whether the kernel's (sums,
    executed) `got` agree with the plain version's `want`): byte for byte,
    or for a DEFAULT variant the executed counts byte for byte and the
    sums within default_bound."""
    (sums, executed), (ref_sums, ref_executed) = got, want
    diff = (sums.double() - ref_sums.double()).abs()
    max_err = float(diff.max()) if diff.numel() else 0.0
    if not torch.equal(executed, ref_executed):
        return max_err, False
    if not VARIANTS[variant][1].get("default"):
        return max_err, torch.equal(sums, ref_sums)
    occ, _ = plain_occ(variant, sphere, planes, jdata)
    bound = default_bound(variant, sphere, planes, jdata, occ)
    return max_err, bool((diff <= bound).all())


def needed_margins(variant, t, executed):
    """The margins a variant's work needs: those of the 8-row groups its
    tiles executed; for noscalar, whose j-rows are all one constant row,
    one row's per tile."""
    if VARIANTS[variant][1].get("noscalar"):
        return t * P * A
    return executed * GROUP * P * A


def run(device, *, t: int = T, nj: int = NJ, reps: int = 5,
        variants=tuple(VARIANTS)):
    """Every variant on the script's inputs (ones j-data) at t tiles and
    nj j-rows on `device`.  Returns {"t", "nj", "variants": {name:
    {"first_ms", "ms", "ns_per_jatom", "margins", "instr_per_margin",
    "instr_per_s", "groups", "executed"}}}: "margins" counts the margins
    the work needs (needed_margins), "groups" the 8-row groups there
    were, "executed" those that ran."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("kernel_experiments.run: no CUDA device")
    sphere, planes, jdata = synthetic_inputs(t, nj, device)
    out = {}
    for name in variants:
        first_ms, ms, (_sums, executed) = _study.timed(
            lambda v=name: experiment(v, sphere, planes, jdata), device, reps)
        groups = t * (jrows(name, nj) // GROUP)
        ran = int(executed.sum())
        margins = needed_margins(name, t, ran)
        per = instr_per_margin(name)
        out[name] = {
            "first_ms": first_ms, "ms": ms,
            "ns_per_jatom": ms * 1e6 / (t * nj),
            "margins": margins, "instr_per_margin": per,
            "instr_per_s": per * margins / (ms * 1e-3),
            "groups": groups, "executed": ran,
        }
    return {"t": t, "nj": nj, "variants": out}


def report(result, device, head: str) -> None:
    print(f"{head}: T={result['t']} tiles x NJ={result['nj']} j-rows x "
          f"{P} points x {A} atoms on {_study.device_name(device)}",
          flush=True)
    full = result["variants"].get("full")
    for name, v in result["variants"].items():
        rel = f" ({v['ms'] / full['ms']:.3f}x full)" if full else ""
        skipped = 1.0 - v["executed"] / max(v["groups"], 1)
        print(f"{name:17s} first {v['first_ms']:9.1f} ms  warm {v['ms']:9.3f} "
              f"ms{rel}  {v['ns_per_jatom']:8.4f} ns/j-atom  "
              f"{v['instr_per_s'] / 1e12:6.2f}T FP32 instr/s at its own work "
              f"({v['instr_per_margin']} per margin)  groups skipped "
              f"{100 * skipped:.2f} %", flush=True)


def main(argv=None) -> int:
    del argv
    if not torch.cuda.is_available():
        print("kernel_experiments: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    report(run(device), device, "kernel_experiments")
    return 0


if __name__ == "__main__":
    sys.exit(main())
