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
// Bound: FP32-pipe issue, 5 packed instructions per 2 margins.  Layout:
// 256 threads, each 16 points (8 pairs) x 4 atoms; the sphere pairs are
// re-read from shared memory for every row, as the script reads its bf16
// sphere scratch.

#include "ke_common.cuh"

namespace {

using namespace ke;

constexpr int kPairs = kPts / 2;

template <bool kSkip>
__global__ void __launch_bounds__(kThreads, 1)
ke_bf16_kernel(const float4* __restrict__ sphere,
               const float* __restrict__ planes,
               const float* __restrict__ jdata, float* __restrict__ out,
               int32_t* __restrict__ executed, int m, int nj) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(smem_raw, nj);
  // The sphere as bf16 point pairs: [3][kP / 2].
  __nv_bfloat162* s2 = reinterpret_cast<__nv_bfloat162*>(s.extra);
  for (int q = threadIdx.x; q < kP / 2; q += kThreads) {
    const float4 lo = sphere[2 * q];
    const float4 hi = sphere[2 * q + 1];
    s2[q] = __floats2bfloat162_rn(lo.x, hi.x);
    s2[kP / 2 + q] = __floats2bfloat162_rn(lo.y, hi.y);
    s2[kP + q] = __floats2bfloat162_rn(lo.z, hi.z);
  }
  stage_inputs(s, sphere, planes, jdata, m, nj);

  const int tid = threadIdx.x;
  const int a0 = (tid % 32) * kAts;
  const int p0 = (tid / 32) * kPts;
  IAtom at[kAts];
#pragma unroll
  for (int k = 0; k < kAts; ++k) at[k] = i_atom(s.irec, a0 + k);
  const __nv_bfloat162 neg_big =
      __bfloat162bfloat162(__float2bfloat16_rn(kNegBig));
  __nv_bfloat162 occ[kPairs][kAts];
#pragma unroll
  for (int q = 0; q < kPairs; ++q)
#pragma unroll
    for (int k = 0; k < kAts; ++k) occ[q][k] = neg_big;

  int groups_run = 0;
  for (int g = 0; g < nj / kGroup; ++g) {
    const float* rows = s.jd + g * kGroup * kJCols;
    if (kSkip && !group_vote(s.irec, rows)) continue;
    ++groups_run;
    float4 lo[kGroup];
    float gk[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      lo[r] = *reinterpret_cast<const float4*>(rows + r * kJCols);
      gk[r] = rows[r * kJCols + 4];
    }
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      __nv_bfloat162 lim2[kAts], vx2[kAts], vy2[kAts], vz2[kAts];
#pragma unroll
      for (int k = 0; k < kAts; ++k) {
        float vx, vy, vz, v2;
        const float lim = limit<true>(at[k], lo[r].x, lo[r].y, lo[r].z,
                                      __fmul_rn(lo[r].w, lo[r].w), gk[r], vx,
                                      vy, vz, v2);
        lim2[k] = __bfloat162bfloat162(__float2bfloat16_rn(lim));
        vx2[k] = __bfloat162bfloat162(__float2bfloat16_rn(vx));
        vy2[k] = __bfloat162bfloat162(__float2bfloat16_rn(vy));
        vz2[k] = __bfloat162bfloat162(__float2bfloat16_rn(vz));
      }
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int pi = p0 / 2 + q;
        const __nv_bfloat162 sx = s2[pi];
        const __nv_bfloat162 sy = s2[kP / 2 + pi];
        const __nv_bfloat162 sz = s2[kP + pi];
#pragma unroll
        for (int k = 0; k < kAts; ++k) {
          const __nv_bfloat162 dots = __hadd2_rn(
              __hmul2_rn(sx, vx2[k]),
              __hadd2_rn(__hmul2_rn(sy, vy2[k]), __hmul2_rn(sz, vz2[k])));
          occ[q][k] = __hmax2(occ[q][k], __hsub2_rn(lim2[k], dots));
        }
      }
    }
  }
  __syncthreads();  // the j-data is no longer read
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
  const size_t smem = base_smem(nj) + sizeof(__nv_bfloat162) * 3 * (kP / 2);
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
