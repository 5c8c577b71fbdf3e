// The packed-bf16 margin stream of the kernel experiments, for NVIDIA
// Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `make_bf16_kernel(skip)`
// (scripts/kernel_experiments.py:417; g8_bf16, g8_bf16_skip): the g8
// stream with its [P, A] part in bf16.  Per 8-row group the limits and
// v = c_i - c_j are computed in f32 (the script's group prologue) and
// rounded to bf16; then, per row and point,
//     occ = max(occ, lim16 - (s_x16*vx16 + (s_y16*vy16 + s_z16*vz16)))
// in bf16, and at the end the f32 sum over the points of occ.  The script
// hoped Mosaic would pack two bf16 values per lane (its docstring,
// :418-422); here every bf16 instruction works on two points at once
// (__nv_bfloat162: __hmul2_rn, __hadd2_rn, __hsub2_rn, __hmax2), each
// rounding once to nearest even, as the plain version's torch bf16 ops do
// (an f32 op rounded to bf16: 24 >= 2 * 8 + 2 bits, so no double
// rounding).  The _rn forms keep the compiler from fusing a multiply and
// an add into one rounding.
//
// Bound: FP32-pipe issue, 7 packed instructions per 2 margins (3 mul,
// 2 add, 1 sub, 1 max), 1.234 ms at T = 512 x NJ = 1,408 (chip_smoke.py's
// ke_bound).  The design keeps the rest off the margins:
//   * each (row, atom) is computed once per CTA: the group prologue
//     (ke_common's group_entries, the f32 limit chain) stores lim, vx, vy
//     and vz as bf16x2 broadcasts into a [row][quantity][atom] slot of
//     16 KB, which a thread (lane l: atoms 4l..4l+3, warp w: points
//     16w..16w+15 as 8 pairs) reads as four LDS.128 per row, the next
//     row's in flight during a row's 224 packed instructions;
//   * the sphere's 8 x 3 point pairs stay in registers;
//   * a two-slot ring: each thread computes group g + 1's prologue
//     beside group g's margins, and one __syncthreads_or per group
//     publishes the slot and votes g + 1's reach test;
//   * ~104 KB of shared memory and <= 128 registers hold two CTAs (16
//     warps) per SM.

#include "ke_common.cuh"

namespace {

using namespace ke;

constexpr int kPairs = kPts / 2;
constexpr int kQuant = 4;  // lim, vx, vy, vz
constexpr int kSlotWords = kGroup * kQuant * kA;

__device__ __forceinline__ uint32_t bf16x2_bits(float x) {
  const __nv_bfloat162 v = __float2bfloat162_rn(x);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// Word k (a constant once unrolled) of v.
__device__ __forceinline__ uint32_t part(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One row's lim, vx, vy, vz for the thread's 4 atoms.
struct RowOps {
  uint4 q[kQuant];
};

__device__ __forceinline__ RowOps row_ops(const uint32_t* row, int a0) {
  RowOps o;
#pragma unroll
  for (int u = 0; u < kQuant; ++u) {
    o.q[u] = *reinterpret_cast<const uint4*>(row + u * kA + a0);
  }
  return o;
}

__device__ __forceinline__ void row_margins(
    __nv_bfloat162 (&occ)[kPairs][kAts], const __nv_bfloat162 (&sx)[kPairs],
    const __nv_bfloat162 (&sy)[kPairs], const __nv_bfloat162 (&sz)[kPairs],
    const RowOps& o) {
#pragma unroll
  for (int k = 0; k < kAts; ++k) {
    const __nv_bfloat162 lim = as_bf16x2(part(o.q[0], k));
    const __nv_bfloat162 vx = as_bf16x2(part(o.q[1], k));
    const __nv_bfloat162 vy = as_bf16x2(part(o.q[2], k));
    const __nv_bfloat162 vz = as_bf16x2(part(o.q[3], k));
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const __nv_bfloat162 dots =
          __hadd2_rn(__hmul2_rn(sx[q], vx),
                     __hadd2_rn(__hmul2_rn(sy[q], vy), __hmul2_rn(sz[q], vz)));
      occ[q][k] = __hmax2(occ[q][k], __hsub2_rn(lim, dots));
    }
  }
}

template <bool kSkip>
__global__ void __launch_bounds__(kThreads, 2)
ke_bf16_kernel(const float4* __restrict__ sphere,
               const float* __restrict__ planes,
               const float* __restrict__ jdata, float* __restrict__ out,
               int32_t* __restrict__ executed, int m, int nj) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(smem_raw, nj);
  uint32_t* slots = reinterpret_cast<uint32_t*>(s.extra);  // [2][8][4][128]
  stage_inputs(s, sphere, planes, jdata, m, nj);

  const int tid = threadIdx.x;
  const int a0 = (tid % 32) * kAts;
  const int p0 = (tid / 32) * kPts;
  // The sphere as bf16 point pairs (p0 + 2q, p0 + 2q + 1).
  __nv_bfloat162 sx[kPairs], sy[kPairs], sz[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const float4 lo = s.sph[p0 + 2 * q];
    const float4 hi = s.sph[p0 + 2 * q + 1];
    sx[q] = __floats2bfloat162_rn(lo.x, hi.x);
    sy[q] = __floats2bfloat162_rn(lo.y, hi.y);
    sz[q] = __floats2bfloat162_rn(lo.z, hi.z);
  }
  const IAtom at = i_atom(s.irec, tid % kA);
  const __nv_bfloat162 neg_big = __float2bfloat162_rn(kNegBig);
  __nv_bfloat162 occ[kPairs][kAts];
#pragma unroll
  for (int q = 0; q < kPairs; ++q)
#pragma unroll
    for (int k = 0; k < kAts; ++k) occ[q][k] = neg_big;

  // Group g's prologue into slot g % 2; returns the thread's reach vote.
  const auto prologue = [&](int g) {
    uint32_t* slot = slots + (g & 1) * kSlotWords;
    return group_entries<true>(
        at, s.jd + g * kGroup * kJCols,
        [&](int r, int a, float vx, float vy, float vz, float lim) {
          uint32_t* e = slot + r * kQuant * kA + a;
          e[0] = bf16x2_bits(lim);
          e[kA] = bf16x2_bits(vx);
          e[2 * kA] = bf16x2_bits(vy);
          e[3 * kA] = bf16x2_bits(vz);
        });
  };
  const int n_groups = nj / kGroup;
  bool hit = __syncthreads_or(prologue(0)) != 0;
  int groups_run = 0;
  for (int g = 0; g < n_groups; ++g) {
    // Slot (g + 1) % 2 was last read in group g - 1, before the last
    // barrier.
    const bool next = g + 1 < n_groups && prologue(g + 1);
    if (!kSkip || hit) {
      ++groups_run;
      const uint32_t* slot = slots + (g & 1) * kSlotWords;
      RowOps ops[2];
      ops[0] = row_ops(slot, a0);
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        if (r + 1 < kGroup) {
          ops[(r + 1) & 1] = row_ops(slot + (r + 1) * kQuant * kA, a0);
        }
        row_margins(occ, sx, sy, sz, ops[r & 1]);
      }
    }
    // Publishes slot (g + 1) % 2 and its vote; after the last group, the
    // j-data is no longer read.
    hit = __syncthreads_or(next) != 0;
  }
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
#pragma unroll
    for (int k = 0; k < kAts; ++k) {
      s.jd[(p0 + 2 * q) * kA + a0 + k] = __low2float(occ[q][k]);
      s.jd[(p0 + 2 * q + 1) * kA + a0 + k] = __high2float(occ[q][k]);
    }
  }
  finish(s, out, executed, groups_run);
}

template <bool kSkip>
int launch(const float4* sphere, const float* planes, const float* jdata,
           float* out, int32_t* executed, int m, int nj, cudaStream_t stream) {
  const size_t smem = base_smem(nj) + sizeof(uint32_t) * 2 * kSlotWords;
  return launch_tiles(ke_bf16_kernel<kSkip>, smem, m, stream, sphere, planes,
                      jdata, out, executed, m, nj);
}

}  // namespace

// Launches variant `variant` (0 g8_bf16, 1 g8_bf16_skip) on `stream`
// without synchronizing; arguments as ke_stream_launch's.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int ke_bf16_launch(const void* sphere, const void* planes,
                              const void* jdata, void* out, void* executed,
                              int m, int nj, int variant, void* stream) {
  if (!valid_shape(m, nj, kGroup)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* sp = static_cast<const float4*>(sphere);
  const auto* pl = static_cast<const float*>(planes);
  const auto* jd = static_cast<const float*>(jdata);
  auto* o = static_cast<float*>(out);
  auto* ex = static_cast<int32_t*>(executed);
  auto st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<false>(sp, pl, jd, o, ex, m, nj, st);
    case 1: return launch<true>(sp, pl, jd, o, ex, m, nj, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
