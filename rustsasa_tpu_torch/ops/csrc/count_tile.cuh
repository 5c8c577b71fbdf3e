// Shared pieces of the occlusion-count kernels (fused_count.cu and its
// variants pair64_count.cu, nibble_count.cu, saturation_count.cu,
// micro_count.cu, reach_count.cu, maxplus_count.cu), for NVIDIA Hopper
// (sm_90a).
//
// fused_count.cu and the studies but maxplus_count.cu take kernel 1's
// reach-skip layout (reach_ring.cuh) and share the arithmetic, IAtom,
// load_i_atom, load_points, count_accessible, row_v, row_lim,
// row_margins and the reach-skip helpers at the end; maxplus_count.cu
// takes its own thread layout and shares only the constants, IAtom,
// load_i_atom, stage_sphere and RUSTSASA_SWITCH_K; reach_count.cu's rule
// kernel splits points as count_split does.  Every operation is an
// explicitly rounded __f*_rn intrinsic in the reference's order, so
// counts equal the reference bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rustsasa {

constexpr int kAtomTile = 128;
constexpr int kHalf = kAtomTile / 2;
constexpr int kJlistRows = 128;
constexpr int kJGroup = 8;
constexpr int kRecords = 5;  // x, y, z, r_eff, gid
constexpr int kSlices = 4;
constexpr int kThreads = kAtomTile * kSlices;
constexpr int kMaxK = 16;
constexpr int kMaxPPad = 2048;
constexpr float kNegBig = -1e30f;

// One i-atom's coordinates and the per-atom factors of its margin.
struct IAtom {
  float x, y, z, r, r2, inv2r, gid;
};

__device__ __forceinline__ IAtom load_i_atom(const float* __restrict__ planes,
                                             int64_t mm, int64_t i) {
  IAtom at;
  at.x = planes[0 * mm + i];
  at.y = planes[1 * mm + i];
  at.z = planes[2 * mm + i];
  at.r = planes[3 * mm + i];
  at.gid = planes[4 * mm + i];
  at.r2 = __fmul_rn(at.r, at.r);
  at.inv2r = __fdiv_rn(0.5f, fmaxf(at.r, 1e-6f));
  return at;
}

// The sphere, zero-padded (valid = 0) to the n_cover points of all
// passes, into shared memory.  The caller synchronizes.
__device__ __forceinline__ void stage_sphere(float4* sph,
                                             const float4* __restrict__ sphere,
                                             int p, int n_cover) {
  for (int q = threadIdx.x; q < n_cover; q += kThreads) {
    sph[q] = q < p ? sphere[q] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Points [p0, p0 + K) of the staged sphere into registers, with running
// max margins starting at -1e30 for valid points and at pad_init for pad
// points (valid = 0).
template <int K>
__device__ __forceinline__ void load_points(const float4* sph, int p0,
                                            float pad_init, float (&sx)[K],
                                            float (&sy)[K], float (&sz)[K],
                                            float (&occ)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 s = sph[p0 + k];
    sx[k] = s.x;
    sy[k] = s.y;
    sz[k] = s.z;
    occ[k] = s.w > 0.0f ? kNegBig : pad_init;
  }
}

// The valid points among [p0, p0 + K) whose max margin is <= 0.
template <int K>
__device__ __forceinline__ int count_accessible(const float4* sph, int p0,
                                                const float (&occ)[K]) {
  int n = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    n += (occ[k] <= 0.0f && sph[p0 + k].w > 0.0f) ? 1 : 0;
  }
  return n;
}

// v = c_i - c_j for j-row jj of the staged tile; returns
// v2 = (vx*vx + vy*vy) + vz*vz.
__device__ __forceinline__ float row_v(const float* jrec, int jj,
                                       const IAtom& at, float& vx, float& vy,
                                       float& vz) {
  vx = __fsub_rn(at.x, jrec[0 * kAtomTile + jj]);
  vy = __fsub_rn(at.y, jrec[1 * kAtomTile + jj]);
  vz = __fsub_rn(at.z, jrec[2 * kAtomTile + jj]);
  return __fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)),
                   __fmul_rn(vz, vz));
}

// v and the per-(i, j) limit of j-row jj:
//   lim = ((r_j*r_j - v2) - r_i*r_i) * (0.5 / max(r_i, 1e-6)),
// with lim = -1e30 where gid_j == gid_i or gid_j == 0 (padding).
__device__ __forceinline__ float row_lim(const float* jrec, int jj,
                                         const IAtom& at, float& vx,
                                         float& vy, float& vz) {
  const float v2 = row_v(jrec, jj, at, vx, vy, vz);
  const float rk = jrec[3 * kAtomTile + jj];
  const float gk = jrec[4 * kAtomTile + jj];
  const float lim = __fmul_rn(
      __fsub_rn(__fsub_rn(__fmul_rn(rk, rk), v2), at.r2), at.inv2r);
  return (at.gid == gk || gk == 0.0f) ? kNegBig : lim;
}

// Max-accumulates one j-atom's margins into occ:
//   margin = lim - (sx*vx + (sy*vy + sz*vz)).
template <int K>
__device__ __forceinline__ void row_margins(float vx, float vy, float vz,
                                            float lim, const float (&sx)[K],
                                            const float (&sy)[K],
                                            const float (&sz)[K],
                                            float (&occ)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float dot = __fadd_rn(
        __fmul_rn(sx[k], vx),
        __fadd_rn(__fmul_rn(sy[k], vy), __fmul_rn(sz[k], vz)));
    occ[k] = fmaxf(occ[k], __fsub_rn(lim, dot));
  }
}

// ---- the reach skip of kernel 1's layout (fused_count.cu keep_pair;
// saturation_count.cu, micro_count.cu, reach_count.cu, nibble_count.cu
// and pair64_count.cu keep_row) ----
//
// A j-row may be left out of an i-atom's max only where all its rounded
// margins are <= 0, so that the count does not move.  keep_pair is that
// test, conservative by construction; fused_count.cu's header derives
// kReachSlack and the two guards.
constexpr float kReachSlack = 1.0f + 0x1p-14f;  // (1 + delta), exact in f32
// Largest |s|^2 (as computed below) of a valid sphere point for which the
// skip holds; a sphere with a longer point streams every gid-kept row.
constexpr float kUnitNorm2 = 1.0f + 0x1p-20f;
// The skip by distance needs r_j >= r_i / kRadiusRatio and r_i >= 1e-6.
constexpr float kRadiusRatio = 8.0f;

// |s|^2 of one sphere point, rounded as v2 is.
__device__ __forceinline__ float point_norm2(float4 s) {
  return __fadd_rn(__fadd_rn(__fmul_rn(s.x, s.x), __fmul_rn(s.y, s.y)),
                   __fmul_rn(s.z, s.z));
}

// Whether i-atom a (x, y, z, r_eff; gid ag) keeps the j-row (jx, jy, jz,
// jr, jg): false where the row's lim is -1e30 (gid_j == gid_i, gid_j == 0)
// or the i-atom is padding (gid 0), and where far_ok and
//     v2 > (r_i + r_j)^2 * kReachSlack,  r_i >= 1e-6,
//     kRadiusRatio * r_j >= r_i,
// with v2 rounded exactly as row_v rounds it, so the test sees the v the
// margins would.
__device__ __forceinline__ bool keep_pair(float4 a, float ag, float jx,
                                          float jy, float jz, float jr,
                                          float jg, bool far_ok) {
  const float vx = __fsub_rn(a.x, jx);
  const float vy = __fsub_rn(a.y, jy);
  const float vz = __fsub_rn(a.z, jz);
  const float v2 = __fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)),
                             __fmul_rn(vz, vz));
  const float reach = __fadd_rn(a.w, jr);
  const bool far = v2 > __fmul_rn(__fmul_rn(reach, reach), kReachSlack);
  const bool skip_far = far_ok && far && a.w >= 1e-6f &&
                        __fmul_rn(kRadiusRatio, jr) >= a.w;
  return !(ag == 0.0f || jg == 0.0f || jg == ag || skip_far);
}

// Smallest v2 at which keep_row skips a row for an i-atom with r_i < 1e-6.
constexpr float kTinyReach2 = 0x1p-30f;

// keep_pair for the study kernels on kernel 1's layout
// (saturation_count.cu, micro_count.cu, reach_count.cu,
// nibble_count.cu, pair64_count.cu), whose counts stay the
// reference's at padding slots too, and whose tile-saturation check sees
// padding atoms' margins: the i-atom's gid drops no row.  Rows are
// dropped where gid_j == 0 or gid_j == gid_i (lim is -1e30 there) and,
// where far_ok, by distance: for r_i >= 1e-6 as keep_pair (whose
// derivation holds whatever the gids), and for r_i < 1e-6 (padding has
// r_eff 0) where
//     v2 >= 2 r_j^2 (rounded) and v2 >= 2^-30.
// Derivation of the second, u = 2^-24: inv2r = 0.5 / 1e-6 rounds to
// 5e5 and r2 = r_i^2 >= 0.  With a = fl(r_j^2) <= v2 / 2, fl(a - v2) <=
// -v2 / 2, subtracting r2 and rounding keep it there, and lim <=
// -5e5 (v2 / 2)(1 - u) < -2.4999e5 v2.  The dot is at most |s| |V|
// (1 + u)^3 in size, |s| <= 1 + 9.51u (far_ok) and |V|^2 <= v2 / (1 -
// 3.01u) (fused_count.cu's header), so |dot| <= 1.00001 sqrt(v2).  A
// rounded margin keeps the sign of lim - dot, so it is <= 0 once
// 2.4999e5 v2 >= 1.00001 sqrt(v2), i.e. v2 >= 1.61e-11: 2^-30 = 9.3e-10
// holds with room.
//
// With slack = kBf16Slack, keep_row serves margins computed in bf16
// (reach_count.cu row_margins_bf16, both variants), whose dot rounds v,
// each product and each sum to bf16 (eps = 2^-8), and in bf16p the limit
// and the margin too.  A rounded margin keeps the sign of its last
// subtraction, so it is <= 0 where bf(lim') <= dot' (bf16p; bf16 needs
// only lim' <= dot').  With s' = bf(s), b = bf(V), each product and the
// two sums rounded once: |dot'| <= (1 + eps)^5 sum_k |s_k| |V_k| <=
// 1.0197 sigma D, and for lim' < 0, bf(lim') <= (1 - eps) lim'.  So the
// margins are <= 0 once (1 - eps)(-lim') >= 1.0197 sigma D, and with
// -lim' >= (D^2 + r_i^2 - r_j^2) / (2 r_i) (less the u terms of
// fused_count.cu's header, 1e-7 relative) that holds, for r_i = 1, where
//     (1 - eps) D^2 - 2.0394 D + (1 - eps)(1 - rho^2) >= 0,  rho = r_j/r_i,
// i.e. past the larger root D*: at the guard's worst ratio rho = 1/8,
// D* = 1.2759 = 1.134 R (R = r_i + r_j); 1.085 R at rho = 1/4, 1.024 R
// at rho = 1, less above.  kBf16Slack = 1.25^2 asks v2 > 1.5625 R^2
// (rounded as kReachSlack's test, u terms far inside the 10 % of room):
// at rho = 1/8 and D = 1.25 R the left side is 0.082 > 0, and it grows
// with D past D*.  For r_i < 1e-6 the bound above scales the same way:
// lim' <= -2.4999e5 v2, (1 - eps) of it against |dot'| <= 1.0198
// sqrt(v2) holds once v2 >= 1.7e-11, inside the 2^-30 floor.
constexpr float kBf16Slack = 1.5625f;

__device__ __forceinline__ bool keep_row(float4 a, float ag, float jx,
                                         float jy, float jz, float jr,
                                         float jg, bool far_ok,
                                         float slack = kReachSlack) {
  const float vx = __fsub_rn(a.x, jx);
  const float vy = __fsub_rn(a.y, jy);
  const float vz = __fsub_rn(a.z, jz);
  const float v2 = __fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)),
                             __fmul_rn(vz, vz));
  bool far;
  if (a.w >= 1e-6f) {
    const float reach = __fadd_rn(a.w, jr);
    far = v2 > __fmul_rn(__fmul_rn(reach, reach), slack) &&
          __fmul_rn(kRadiusRatio, jr) >= a.w;
  } else {
    far = v2 >= __fmul_rn(2.0f, __fmul_rn(jr, jr)) && v2 >= kTinyReach2;
  }
  return !(jg == 0.0f || jg == ag || (far_ok && far));
}

// row_lim with the gid test replaced by `keep` (keep_pair of this atom and
// row): lim = -1e30 where the atom does not keep j-row jj.  Where keep_pair
// skipped a gid-kept row by distance, -1e30 - dot <= 0 stands in for a
// margin that is <= 0 too, so the count is the same.
__device__ __forceinline__ float row_lim_kept(const float* jrec, int jj,
                                              const IAtom& at, bool keep,
                                              float& vx, float& vy,
                                              float& vz) {
  const float v2 = row_v(jrec, jj, at, vx, vy, vz);
  const float rk = jrec[3 * kAtomTile + jj];
  const float lim = __fmul_rn(
      __fsub_rn(__fsub_rn(__fmul_rn(rk, rk), v2), at.r2), at.inv2r);
  return keep ? lim : kNegBig;
}

// Fewest passes of kSlices x kMaxK points, then the smallest K covering
// p; false when p is out of range.  rustsasa_tpu_torch.ops._kernels.
// point_passes is the same split.
inline bool count_split(int p, int* passes, int* k) {
  if (p <= 0 || p > kMaxPPad) return false;
  *passes = (p + kSlices * kMaxK - 1) / (kSlices * kMaxK);
  *k = (p + kSlices * *passes - 1) / (kSlices * *passes);
  return true;
}

}  // namespace rustsasa

// `switch (k)` over the 16 template instantiations K = 1..16, each
// returning the value of the expression given after k (which names K).
#define RUSTSASA_CASE_K(N, ...) \
  case N: {                     \
    constexpr int K = N;        \
    return __VA_ARGS__;         \
  }
#define RUSTSASA_SWITCH_K(k, ...)                                          \
  switch (k) {                                                             \
    RUSTSASA_CASE_K(1, __VA_ARGS__) RUSTSASA_CASE_K(2, __VA_ARGS__)        \
    RUSTSASA_CASE_K(3, __VA_ARGS__) RUSTSASA_CASE_K(4, __VA_ARGS__)        \
    RUSTSASA_CASE_K(5, __VA_ARGS__) RUSTSASA_CASE_K(6, __VA_ARGS__)        \
    RUSTSASA_CASE_K(7, __VA_ARGS__) RUSTSASA_CASE_K(8, __VA_ARGS__)        \
    RUSTSASA_CASE_K(9, __VA_ARGS__) RUSTSASA_CASE_K(10, __VA_ARGS__)       \
    RUSTSASA_CASE_K(11, __VA_ARGS__) RUSTSASA_CASE_K(12, __VA_ARGS__)      \
    RUSTSASA_CASE_K(13, __VA_ARGS__) RUSTSASA_CASE_K(14, __VA_ARGS__)      \
    RUSTSASA_CASE_K(15, __VA_ARGS__) RUSTSASA_CASE_K(16, __VA_ARGS__)      \
    default:                                                               \
      return static_cast<int>(cudaErrorInvalidValue);                      \
  }
