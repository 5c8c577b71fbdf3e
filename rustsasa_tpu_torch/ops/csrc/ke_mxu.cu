// The per-j dot products of the kernel experiments on a matrix unit, for
// NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `make_mxu_dots_kernel(precision, skip)`
// (scripts/kernel_experiments.py:502; mxu_dots_hi, mxu_dots_def,
// mxu_dots_hi_skip).  Per j-row the script takes the dots
// s_p.(c_i - c_j) as one [P, 8] x [8, A] product on the TPU's matrix unit
// (rows vx, vy, vz and five zeros), so that the vector unit only does
// occ = max(occ, lim - dots).  Per 8-row group a prologue computes each
// (row, atom)'s v and limit once into shared memory (the script's
// [8, A] group arrays), with the reach vote of `skip`.  Then, per row:
//   * HIGHEST (hi, hi_skip): the products in full f32 on the CUDA cores,
//     in the order XLA-CPU's zero-padded K = 8 dot takes them,
//     fma(s_z, vz, fma(s_y, vy, s_x*vx)); 16 points x 4 atoms a thread;
//   * DEFAULT (def): what a TPU runs as one bf16 pass with f32
//     accumulation, on the tensor cores: mma.sync m16n8k16 with the sphere
//     (K padded 3 -> 16) as the A fragment, loaded once, and
//     (vx, vy, vz, 0...) of 8 atoms as the B fragment; warp w owns points
//     16w..16w+15 and all 128 atoms, 16 mma per row, and keeps occ in the
//     accumulator layout.  The products of bf16 operands are exact; the
//     tensor core sums them in its own order, so its dots may lie a few
//     ulp from the plain version's ((p_x + p_y) + p_z), within the bound
//     kernel_experiments.default_bound states.
// No library product: the mma is issued from this kernel's body.
//
// Bound: FP32 issue, 5 instructions per margin for HIGHEST (mul, 2 fma,
// sub, max) and 2 for DEFAULT (sub, max; 16 mma per 128 x 128 margins
// beside them on the tensor cores).

#include "ke_common.cuh"

namespace {

using namespace ke;

// Per-group buffers: vx, vy, vz, lim [8][128] f32, then the B fragments'
// bf16 pairs (vx, vy) and (vz, 0) [8][128].
constexpr int kGroupFloats = 4 * kGroup * kA;
constexpr size_t kExtra = sizeof(float) * kGroupFloats +
                          sizeof(uint32_t) * 2 * kGroup * kA;

template <bool kDef, bool kSkip>
__global__ void __launch_bounds__(kThreads, 1)
ke_mxu_kernel(const float4* __restrict__ sphere,
              const float* __restrict__ planes,
              const float* __restrict__ jdata, float* __restrict__ out,
              int32_t* __restrict__ executed, int m, int nj) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(smem_raw, nj);
  stage_inputs(s, sphere, planes, jdata, m, nj);
  float* gv = s.extra;  // [4][8][128]
  uint32_t* gb = reinterpret_cast<uint32_t*>(s.extra + kGroupFloats);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // HIGHEST layout: points p0 + 0..15, atoms a0 + 0..3.
  const int a0 = lane * kAts;
  const int p0 = warp * kPts;
  // DEFAULT layout: mma rows (points) warp*16 + gid and + 8, columns
  // (atoms) nt*8 + 2*tig + {0, 1}.
  const int gid = lane / 4;
  const int tig = lane % 4;

  float occ[kPts][kAts];
#pragma unroll
  for (int q = 0; q < kPts; ++q)
#pragma unroll
    for (int k = 0; k < kAts; ++k) occ[q][k] = kNegBig;
  float4 sreg[kDef ? 1 : kPts];
  uint32_t afrag[4] = {0u, 0u, 0u, 0u};
  if (kDef) {
    const float4 lo = s.sph[warp * 16 + gid];
    const float4 hi = s.sph[warp * 16 + gid + 8];
    if (tig == 0) {
      afrag[0] = pack_bf16(lo.x, lo.y);
      afrag[1] = pack_bf16(hi.x, hi.y);
    } else if (tig == 1) {
      afrag[0] = pack_bf16(lo.z, 0.0f);
      afrag[1] = pack_bf16(hi.z, 0.0f);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPts; ++q) sreg[kDef ? 0 : q] = s.sph[p0 + q];
  }

  int groups_run = 0;
  for (int g = 0; g < nj / kGroup; ++g) {
    __syncthreads();  // the previous group's buffers are read
    const bool hit = group_prologue<true>(
        s.irec, s.jd + g * kGroup * kJCols,
        [&](int r, int a, float vx, float vy, float vz, float lim) {
          const int e = r * kA + a;
          gv[e] = vx;
          gv[kGroup * kA + e] = vy;
          gv[2 * kGroup * kA + e] = vz;
          gv[3 * kGroup * kA + e] = lim;
          gb[e] = pack_bf16(vx, vy);
          gb[kGroup * kA + e] = pack_bf16(vz, 0.0f);
        });
    if (kSkip && !hit) continue;
    ++groups_run;
#pragma unroll 1
    for (int r = 0; r < kGroup; ++r) {
      const int e = r * kA;
      if (kDef) {
        const float* lim = gv + 3 * kGroup * kA + e;
#pragma unroll
        for (int nt = 0; nt < kA / 8; ++nt) {
          const int col = nt * 8 + gid;
          const uint32_t b0 = tig == 0 ? gb[e + col]
                              : tig == 1 ? gb[kGroup * kA + e + col] : 0u;
          float d[4];
          mma_bf16(afrag, b0, 0u, d);
          const float2 l = *reinterpret_cast<const float2*>(
              lim + nt * 8 + 2 * tig);
          // occ[nt][c] in the accumulator layout, over the HIGHEST array.
          occ[nt][0] = fmaxf(occ[nt][0], __fsub_rn(l.x, d[0]));
          occ[nt][1] = fmaxf(occ[nt][1], __fsub_rn(l.y, d[1]));
          occ[nt][2] = fmaxf(occ[nt][2], __fsub_rn(l.x, d[2]));
          occ[nt][3] = fmaxf(occ[nt][3], __fsub_rn(l.y, d[3]));
        }
      } else {
        const float4 vx = *reinterpret_cast<const float4*>(gv + e + a0);
        const float4 vy =
            *reinterpret_cast<const float4*>(gv + kGroup * kA + e + a0);
        const float4 vz =
            *reinterpret_cast<const float4*>(gv + 2 * kGroup * kA + e + a0);
        const float4 lm =
            *reinterpret_cast<const float4*>(gv + 3 * kGroup * kA + e + a0);
        const float vxs[4] = {vx.x, vx.y, vx.z, vx.w};
        const float vys[4] = {vy.x, vy.y, vy.z, vy.w};
        const float vzs[4] = {vz.x, vz.y, vz.z, vz.w};
        const float lms[4] = {lm.x, lm.y, lm.z, lm.w};
#pragma unroll
        for (int q = 0; q < kPts; ++q) {
          const float4 sp = sreg[kDef ? 0 : q];
#pragma unroll
          for (int k = 0; k < kAts; ++k) {
            const float dots = __fmaf_rn(
                sp.z, vzs[k], __fmaf_rn(sp.y, vys[k], __fmul_rn(sp.x, vxs[k])));
            occ[q][k] = fmaxf(occ[q][k], __fsub_rn(lms[k], dots));
          }
        }
      }
    }
  }
  if (kDef) {
    __syncthreads();  // the j-data is no longer read
#pragma unroll
    for (int nt = 0; nt < kA / 8; ++nt) {
      const int col = nt * 8 + 2 * tig;
      const int row = warp * 16 + gid;
      *reinterpret_cast<float2*>(s.jd + row * kA + col) =
          make_float2(occ[nt][0], occ[nt][1]);
      *reinterpret_cast<float2*>(s.jd + (row + 8) * kA + col) =
          make_float2(occ[nt][2], occ[nt][3]);
    }
  } else {
    stage_occ(s, occ, p0, a0);
  }
  finish(s, out, executed, groups_run);
}

template <bool kDef, bool kSkip>
int launch(const float4* sphere, const float* planes, const float* jdata,
           float* out, int32_t* executed, int m, int nj, cudaStream_t stream) {
  return launch_tiles(ke_mxu_kernel<kDef, kSkip>, base_smem(nj) + kExtra, m,
                      stream, sphere, planes, jdata, out, executed, m, nj);
}

}  // namespace

// Launches variant `variant` (0 mxu_dots_hi, 1 mxu_dots_def,
// 2 mxu_dots_hi_skip) on `stream` without synchronizing; arguments as
// ke_stream_launch's.  Returns the cudaError_t of the launch (0 = success).
extern "C" int ke_mxu_launch(const void* sphere, const void* planes,
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
    case 0: return launch<false, false>(sp, pl, jd, o, ex, m, nj, st);
    case 1: return launch<true, false>(sp, pl, jd, o, ex, m, nj, st);
    case 2: return launch<false, true>(sp, pl, jd, o, ex, m, nj, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
