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
// j-tile (per_tile) or a [P, 8] x [8, 8] one per 8-row group:
//   * HIGHEST: on the CUDA cores, as XLA-CPU's zero-padded dots compute
//     it, fma(s_z, z_j, fma(s_y, y_j, s_x * x_j));
//   * DEFAULT: what a TPU runs as one bf16 pass with f32 accumulation, on
//     the tensor cores: mma.sync m16n8k16, the warp's 8 points (K padded
//     3 -> 16) as rows 0-7 of the A fragment, (x_j, y_j, z_j, 0...) of 8
//     j-rows as the B fragment.
// `sat` adds the script's per-j-tile saturation test min over (p, i) of
// (occ - SXI) > 1e30, SXI = s_p.c_i (HIGHEST), with the block-wide min
// through __syncthreads_and; it never fires on these data.
//
// Bound: FP32 issue, 2 instructions per margin (FADD, FMNMX), 0.705 ms at
// T = 512 x NJ = 1,408 (chip_smoke.py's ke_bound).  The design keeps the
// rest off the margins and off barriers:
//   * 512 threads (16 warps on the SM, one CTA), each 8 points x 4 atoms:
//     lane l takes atoms 4l..4l+3, warp w points 8w..8w+7, occ in 32
//     registers.  Per row a thread reads its 4 limits as one LDS.128 and
//     its 8 points' SXJ as two broadcast LDS.128, and the next row's are in
//     flight while a row's 64 FP32 instructions run;
//   * the limits of a whole 128-row j-tile, [128 rows][128 atoms] f32 =
//     64 KB, are computed once per CTA (warp w: group w, lane l: atoms
//     4l..4l+3, so warp w also votes group w's reach test with __any_sync)
//     between two barriers per j-tile, instead of two per 8-row group;
//   * SXJ is private to the warp that reads it (its 8 points), so it needs
//     no CTA barrier: mp_tile computes its [128 j][8 p] once per j-tile
//     beside the limits (64 KB for the 16 warps), mp_group its [8 j][8 p]
//     in each group's own step (one __syncwarp);
//   * `sat` keeps its 8 x 4 SXI values in registers, and its
//     __syncthreads_and is the j-tile's closing barrier.
// Every SXJ, SXI and limit keeps its __fmaf_rn or __f*_rn chain, and max
// is exact, so moving work between threads changes no bit.
// Shared memory: 202,304 bytes (mp_tile) or 144,960 (mp_group) at NJ <=
// 2,048.

#include "ke_common.cuh"

namespace {

using namespace ke;

constexpr int kJTile = 128;
constexpr int kMpThreads = 512;
constexpr int kMpWarps = kMpThreads / 32;
constexpr int kMpPts = kP / kMpWarps;  // points per thread (its warp's)
constexpr int kTileGroups = kJTile / kGroup;
static_assert(kTileGroups == kMpWarps, "warp w computes group w's limits");

// dot3 as XLA-CPU computes a zero-padded K <= 128 f32 dot at HIGHEST.
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

// The A fragment of the sphere: rows 0-7 the warp's points p0 + 0..7,
// rows 8-15 zero.
__device__ __forceinline__ void sphere_fragment(const float4* sph, int p0,
                                                int lane, uint32_t (&a)[4]) {
  const float4 sp = sph[p0 + lane / 4];
  a[0] = a[1] = a[2] = a[3] = 0u;
  if (lane % 4 == 0) {
    a[0] = pack_bf16(sp.x, sp.y);
  } else if (lane % 4 == 1) {
    a[0] = pack_bf16(sp.z, 0.0f);
  }
}

// The warp's SXJ[j][p] for the `n` j-rows at `rows` (n a multiple of 8)
// and its 8 points, into wx[j * 8 + p]; sp is point p0 + lane % 8.
template <bool kDef, int kN>
__device__ __forceinline__ void warp_products(float4 sp,
                                              const uint32_t (&afrag)[4],
                                              const float* rows, float* wx,
                                              int lane) {
  if (!kDef) {
#pragma unroll 8
    for (int j = lane / 8; j < kN; j += 4) {
      const float4 c = *reinterpret_cast<const float4*>(rows + j * kJCols);
      wx[j * kMpPts + lane % 8] = dot3(sp.x, c.x, sp.y, c.y, sp.z, c.z);
    }
    return;
  }
  const int gid = lane / 4;
  const int tig = lane % 4;
#pragma unroll 4
  for (int nt = 0; nt < kN / 8; ++nt) {
    const float4 c =
        *reinterpret_cast<const float4*>(rows + (nt * 8 + gid) * kJCols);
    const uint32_t b0 = tig == 0   ? pack_bf16(c.x, c.y)
                        : tig == 1 ? pack_bf16(c.z, 0.0f)
                                   : 0u;
    float d[4];
    mma_bf16(afrag, b0, 0u, d);
    const int j = nt * 8 + 2 * tig;
    wx[j * kMpPts + gid] = d[0];
    wx[(j + 1) * kMpPts + gid] = d[1];
  }
}

// Component k (a constant once unrolled) of v.
__device__ __forceinline__ float part(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The limits of j-tile `tile` for warp `warp`'s group (rows 8w..8w+7) and
// atoms a0..a0+3 into lim[row][atom]; returns the thread's part of the
// group's reach vote.
__device__ __forceinline__ bool group_limits(const float* irec,
                                             const float* tile, float* lim,
                                             int warp, int a0) {
  float4 rec[kRecords];
#pragma unroll
  for (int q = 0; q < kRecords; ++q) {
    rec[q] = *reinterpret_cast<const float4*>(irec + q * kA + a0);
  }
  IAtom at[kAts];
#pragma unroll
  for (int k = 0; k < kAts; ++k) {
    at[k] = IAtom{part(rec[0], k), part(rec[1], k), part(rec[2], k),
                  part(rec[3], k), part(rec[4], k), part(rec[5], k),
                  part(rec[6], k)};
  }
  bool hit = false;
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    const float* row = tile + (warp * kGroup + r) * kJCols;
    const float4 c = *reinterpret_cast<const float4*>(row);
    const float gk = row[4];
    const float rr = __fmul_rn(c.w, c.w);
    float l[kAts];
#pragma unroll
    for (int k = 0; k < kAts; ++k) {
      float vx, vy, vz, v2;
      l[k] = limit<true>(at[k], c.x, c.y, c.z, rr, gk, vx, vy, vz, v2);
      hit |= reaches(v2, at[k].r, c.w);
    }
    *reinterpret_cast<float4*>(lim + (warp * kGroup + r) * kA + a0) =
        make_float4(l[0], l[1], l[2], l[3]);
  }
  return hit;
}

// One row's operands: 4 limits, 8 SXJ values.
struct RowOps {
  float4 l, x0, x1;
};

__device__ __forceinline__ RowOps row_ops(const float* lim, const float* wx) {
  return RowOps{*reinterpret_cast<const float4*>(lim),
                *reinterpret_cast<const float4*>(wx),
                *reinterpret_cast<const float4*>(wx + 4)};
}

__device__ __forceinline__ void row_margins(float (&occ)[kMpPts][kAts],
                                            const RowOps& o) {
  const float l[kAts] = {o.l.x, o.l.y, o.l.z, o.l.w};
  const float x[kMpPts] = {o.x0.x, o.x0.y, o.x0.z, o.x0.w,
                           o.x1.x, o.x1.y, o.x1.z, o.x1.w};
#pragma unroll
  for (int q = 0; q < kMpPts; ++q)
#pragma unroll
    for (int k = 0; k < kAts; ++k)
      occ[q][k] = fmaxf(occ[q][k], __fadd_rn(x[q], l[k]));
}

// The 8 rows of one group: lim at its first row and the thread's atoms,
// wx at its first row's SXJ; row r + 1's loads in flight during row r.
__device__ __forceinline__ void group_margins(float (&occ)[kMpPts][kAts],
                                              const float* lim,
                                              const float* wx) {
  RowOps ops[2];
  ops[0] = row_ops(lim, wx);
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    if (r + 1 < kGroup) {
      ops[(r + 1) & 1] = row_ops(lim + (r + 1) * kA, wx + (r + 1) * kMpPts);
    }
    row_margins(occ, ops[r & 1]);
  }
}

template <bool kTile, bool kDef, bool kSkip, bool kSat>
__global__ void __launch_bounds__(kMpThreads, 1)
ke_maxplus_kernel(const float4* __restrict__ sphere,
                  const float* __restrict__ planes,
                  const float* __restrict__ jdata, float* __restrict__ out,
                  int32_t* __restrict__ executed, int m, int nj) {
  static_assert(kTile || !kSkip, "mp_group's warp slots assume no skips");
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(smem_raw, nj);
  float* lim = s.extra;                   // [128 rows][128 atoms]
  float* wxs = lim + kJTile * kA;         // per warp [128 or 2 x 8][8]
  constexpr int kWarpX = (kTile ? kJTile : 2 * kGroup) * kMpPts;
  int* votes = reinterpret_cast<int*>(wxs + kMpWarps * kWarpX);  // [16]
  stage_inputs<kMpThreads>(s, sphere, planes, jdata, m, nj);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int a0 = lane * kAts;
  const int p0 = warp * kMpPts;
  float* wx = wxs + warp * kWarpX;
  uint32_t afrag[4] = {0u, 0u, 0u, 0u};
  if (kDef) sphere_fragment(s.sph, p0, lane, afrag);
  const float4 sp_own = s.sph[p0 + lane % 8];
  float sxi[kMpPts][kAts];
  if (kSat) {
#pragma unroll
    for (int q = 0; q < kMpPts; ++q) {
      const float4 sp = s.sph[p0 + q];
#pragma unroll
      for (int k = 0; k < kAts; ++k) {
        const int a = a0 + k;
        sxi[q][k] = dot3(sp.x, s.irec[a], sp.y, s.irec[kA + a], sp.z,
                         s.irec[2 * kA + a]);
      }
    }
  }
  float occ[kMpPts][kAts];
#pragma unroll
  for (int q = 0; q < kMpPts; ++q)
#pragma unroll
    for (int k = 0; k < kAts; ++k) occ[q][k] = kNegBig;

  int groups_run = 0;
  for (int t = 0; t < nj / kJTile; ++t) {
    const float* tile = s.jd + t * kJTile * kJCols;
    // The previous tile's limits and votes are read (sat: its
    // __syncthreads_and).
    if (t > 0 && !kSat) __syncthreads();
    const bool hit = group_limits(s.irec, tile, lim, warp, a0);
    const bool vote = __any_sync(0xffffffffu, hit);
    if (lane == 0) votes[warp] = vote ? 1 : 0;
    if (kTile) warp_products<kDef, kJTile>(sp_own, afrag, tile, wx, lane);
    __syncthreads();  // the tile's limits and votes are published
    for (int g = 0; g < kTileGroups; ++g) {
      if (kSkip && votes[g] == 0) continue;
      ++groups_run;
      float* gx = wx + (kTile ? g : g & 1) * kGroup * kMpPts;
      if (!kTile) {
        // Slot g % 2 was last read in group g - 2, before the last
        // __syncwarp.
        warp_products<kDef, kGroup>(sp_own, afrag, tile + g * kGroup * kJCols,
                                    gx, lane);
        __syncwarp();
      }
      group_margins(occ, lim + g * kGroup * kA + a0, gx);
    }
    if (kSat) {
      float low = __int_as_float(0x7f800000);  // +inf
#pragma unroll
      for (int q = 0; q < kMpPts; ++q)
#pragma unroll
        for (int k = 0; k < kAts; ++k)
          low = fminf(low, __fsub_rn(occ[q][k], sxi[q][k]));
      if (__syncthreads_and(low > 1e30f)) {
#pragma unroll
        for (int q = 0; q < kMpPts; ++q)
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
      sizeof(float) * (kJTile * kA +
                       kMpWarps * (kTile ? kJTile : 2 * kGroup) * kMpPts) +
      sizeof(int) * kMpWarps;
  return launch_tiles<kMpThreads>(ke_maxplus_kernel<kTile, kDef, kSkip, kSat>,
                                  smem, m, stream, sphere, planes, jdata, out,
                                  executed, m, nj);
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
