// The max-plus form of the kernel experiments, for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel `make_v3_kernel(per_tile, static_groups,
// precision, skip, sat)` (scripts/kernel_experiments.py:298; mp_tile_hi,
// mp_tile_def, mp_tile_hi_skip, mp_group_hi, mp_group_def,
// mp_tile_hi_sat).  The script splits the dot s_p.(c_i - c_j) and keeps
// only its j part: per i-atom, the sum over points of
//     max_j (SXJ[p, j] + lim_ij),   SXJ[p, j] = s_p.c_j,
// over the nj // 128 whole j-tiles of the resident j-data (so each margin
// costs an add and a max).  SXJ is one [P, 128] x [128 j, 128] product per
// j-tile (per_tile) or a [P, 8] x [8, 8] one per 8-row group, computed in
// this kernel's body and staged in shared memory as [j][p]:
//   * HIGHEST: on the CUDA cores, as XLA-CPU's zero-padded dots compute
//     it, fma(s_z, z_j, fma(s_y, y_j, s_x * x_j));
//   * DEFAULT: what a TPU runs as one bf16 pass with f32 accumulation, on
//     the tensor cores: mma.sync m16n8k16, the sphere (K padded 3 -> 16) as
//     the A fragment, (x_j, y_j, z_j, 0...) of 8 j-rows as the B fragment;
//     warp w computes points 16w..16w+15.
// Per group a prologue computes the [8][128] limits once into shared
// memory, with the reach vote of `skip`.  `sat` adds the script's
// per-j-tile saturation test min over (p, i) of (occ - SXI) > 1e30,
// SXI = s_p.c_i staged once as [p][i] (HIGHEST), with the block-wide min
// kept live through __syncthreads_and; it never fires on these data.
//
// Bound: FP32 issue, 2 instructions per margin; per j-row a thread also
// reads its 16 points' SXJ as 4 broadcast LDS.128 and its 4 limits as one.

#include "ke_common.cuh"

namespace {

using namespace ke;

constexpr int kJTile = 128;

// dot3 as XLA-CPU computes a zero-padded K <= 128 f32 dot at HIGHEST.
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

// The A fragment of the sphere for warp `warp` (points warp*16 + 0..15).
__device__ __forceinline__ void sphere_fragment(const float4* sph, int warp,
                                                int lane, uint32_t (&a)[4]) {
  const int gid = lane / 4;
  const int tig = lane % 4;
  const float4 lo = sph[warp * 16 + gid];
  const float4 hi = sph[warp * 16 + gid + 8];
  a[0] = a[1] = a[2] = a[3] = 0u;
  if (tig == 0) {
    a[0] = pack_bf16(lo.x, lo.y);
    a[1] = pack_bf16(hi.x, hi.y);
  } else if (tig == 1) {
    a[0] = pack_bf16(lo.z, 0.0f);
    a[1] = pack_bf16(hi.z, 0.0f);
  }
}

// SXJ[j][p] for the `n` j-rows at `rows` (n a multiple of 8), into
// sxj[j * kP + p].
template <bool kDef>
__device__ __forceinline__ void products(const float4* sph,
                                         const uint32_t (&afrag)[4],
                                         const float* rows, int n,
                                         float* sxj) {
  const int tid = threadIdx.x;
  if (!kDef) {
    for (int q = tid; q < n * kP; q += kThreads) {
      const int j = q / kP;
      const int p = q % kP;
      const float4 sp = sph[p];
      const float* row = rows + j * kJCols;
      sxj[q] = dot3(sp.x, row[0], sp.y, row[1], sp.z, row[2]);
    }
    return;
  }
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int p = warp * 16 + gid;
  for (int nt = 0; nt < n / 8; ++nt) {
    const float* row = rows + (nt * 8 + gid) * kJCols;
    const uint32_t b0 = tig == 0   ? pack_bf16(row[0], row[1])
                        : tig == 1 ? pack_bf16(row[2], 0.0f)
                                   : 0u;
    float d[4];
    mma_bf16(afrag, b0, 0u, d);
    const int j = nt * 8 + 2 * tig;
    sxj[j * kP + p] = d[0];
    sxj[(j + 1) * kP + p] = d[1];
    sxj[j * kP + p + 8] = d[2];
    sxj[(j + 1) * kP + p + 8] = d[3];
  }
}

template <bool kTile, bool kDef, bool kSkip, bool kSat>
__global__ void __launch_bounds__(kThreads, 1)
ke_maxplus_kernel(const float4* __restrict__ sphere,
                  const float* __restrict__ planes,
                  const float* __restrict__ jdata, float* __restrict__ out,
                  int32_t* __restrict__ executed, int m, int nj) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(smem_raw, nj);
  stage_inputs(s, sphere, planes, jdata, m, nj);
  float* glim = s.extra;               // [8][128]
  float* sxj = glim + kGroup * kA;     // [128 or 8][kP]
  float* sxi = sxj + (kTile ? kJTile : kGroup) * kP;  // [kP][kA] (sat)

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int a0 = lane * kAts;
  const int p0 = warp * kPts;
  uint32_t afrag[4];
  sphere_fragment(s.sph, warp, lane, afrag);
  if (kSat) {
    for (int q = tid; q < kP * kA; q += kThreads) {
      const float4 sp = s.sph[q / kA];
      const int a = q % kA;
      sxi[q] = dot3(sp.x, s.irec[a], sp.y, s.irec[kA + a], sp.z,
                    s.irec[2 * kA + a]);
    }
  }
  float occ[kPts][kAts];
#pragma unroll
  for (int q = 0; q < kPts; ++q)
#pragma unroll
    for (int k = 0; k < kAts; ++k) occ[q][k] = kNegBig;

  int groups_run = 0;
  for (int t = 0; t < nj / kJTile; ++t) {
    const float* tile = s.jd + t * kJTile * kJCols;
    if (kTile) {
      __syncthreads();  // the previous tile's SXJ is read
      products<kDef>(s.sph, afrag, tile, kJTile, sxj);
    }
    for (int g = 0; g < kJTile / kGroup; ++g) {
      const float* rows = tile + g * kGroup * kJCols;
      __syncthreads();  // the previous group's buffers are read
      if (!kTile) products<kDef>(s.sph, afrag, rows, kGroup, sxj);
      const bool hit = group_prologue<true>(
          s.irec, rows,
          [&](int r, int a, float, float, float, float lim) {
            glim[r * kA + a] = lim;
          });
      if (kSkip && !hit) continue;
      ++groups_run;
      const float* gs = kTile ? sxj + g * kGroup * kP : sxj;
#pragma unroll 1
      for (int r = 0; r < kGroup; ++r) {
        const float4 l4 = *reinterpret_cast<const float4*>(glim + r * kA + a0);
        const float lim[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int q4 = 0; q4 < kPts / 4; ++q4) {
          const float4 x4 =
              *reinterpret_cast<const float4*>(gs + r * kP + p0 + 4 * q4);
          const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int k = 0; k < kAts; ++k)
              occ[4 * q4 + u][k] =
                  fmaxf(occ[4 * q4 + u][k], __fadd_rn(x[u], lim[k]));
        }
      }
    }
    if (kSat) {
      float low = __int_as_float(0x7f800000);  // +inf
#pragma unroll
      for (int q = 0; q < kPts; ++q)
#pragma unroll
        for (int k = 0; k < kAts; ++k)
          low = fminf(low, __fsub_rn(occ[q][k],
                                     sxi[(p0 + q) * kA + a0 + k]));
      if (__syncthreads_and(low > 1e30f)) {
#pragma unroll
        for (int q = 0; q < kPts; ++q)
#pragma unroll
          for (int k = 0; k < kAts; ++k)
            occ[q][k] = __fsub_rn(occ[q][k], 1.0f);
      }
    }
  }
  stage_occ(s, occ, p0, a0);
  finish(s, out, executed, groups_run);
}

template <bool kTile, bool kDef, bool kSkip, bool kSat>
int launch(const float4* sphere, const float* planes, const float* jdata,
           float* out, int32_t* executed, int m, int nj, cudaStream_t stream) {
  const size_t smem =
      base_smem(nj) +
      sizeof(float) * (kGroup * kA + (kTile ? kJTile : kGroup) * kP +
                       (kSat ? kP * kA : 0));
  return launch_tiles(ke_maxplus_kernel<kTile, kDef, kSkip, kSat>, smem, m,
                      stream, sphere, planes, jdata, out, executed, m, nj);
}

}  // namespace

// Launches variant `variant` (0 mp_tile_hi, 1 mp_tile_def,
// 2 mp_tile_hi_skip, 3 mp_group_hi, 4 mp_group_def, 5 mp_tile_hi_sat) on
// `stream` without synchronizing; arguments as ke_stream_launch's, with nj
// a positive multiple of 128.  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int ke_maxplus_launch(const void* sphere, const void* planes,
                                 const void* jdata, void* out, void* executed,
                                 int m, int nj, int variant, void* stream) {
  if (!valid_shape(m, nj, kJTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* sp = static_cast<const float4*>(sphere);
  const auto* pl = static_cast<const float*>(planes);
  const auto* jd = static_cast<const float*>(jdata);
  auto* o = static_cast<float*>(out);
  auto* ex = static_cast<int32_t*>(executed);
  auto st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<true, false, false, false>(sp, pl, jd, o, ex, m, nj, st);
    case 1: return launch<true, true, false, false>(sp, pl, jd, o, ex, m, nj, st);
    case 2: return launch<true, false, true, false>(sp, pl, jd, o, ex, m, nj, st);
    case 3: return launch<false, false, false, false>(sp, pl, jd, o, ex, m, nj, st);
    case 4: return launch<false, true, false, false>(sp, pl, jd, o, ex, m, nj, st);
    case 5: return launch<true, false, false, true>(sp, pl, jd, o, ex, m, nj, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
