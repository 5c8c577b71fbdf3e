// Reach-test variants of the occlusion-count kernel for NVIDIA Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel built by `make_kernel(variant)`
// (scripts/r3_kernel_variants.py, launched by `run_variant_counts`).  It
// predates group masks: every live j-list entry streams all of its
// j-tile, and a reach test on the staged rows, not a host mask, decides
// what is computed.  Entries are read as j_tile = entry & 0xFFFF (the
// script took the raw entry; mask bits are ignored).  Row jj of the
// staged tile is in reach when v2 - (r_i + r_j)^2 < 0 for some of the
// i-tile's 128 atoms, padding lanes included (count_tile.cuh in_reach,
// publish_reach).  Variants:
//   base         an 8-row group runs when some row of it is in reach;
//   nogroupcond  every row of every entry runs (no test);
//   jskip        as base, and within a group only the rows in reach;
//   group4       jskip over 4-row groups;
//   nocond       as base (the script's jskip without its per-row cond);
//   bf16         as base, with the point-offset dot in bf16 and the
//                running max in f32;
//   bf16p        as bf16, with the limit, the margin and the max in bf16.
// The bf16 variants round where the script's ops round on XLA's CPU
// backend (see row_margins_bf16): each operation is done in f32 (exact
// for a product of two bf16 values) and rounded by __float2bfloat16_rn,
// which for one operation gives the correctly rounded bf16 result, as
// torch's bf16 elementwise ops do.  executed[tile] sums
// the j-rows streamed over the entries of all point passes.
//
// Bound: FP32 ALU throughput, 7 instructions per streamed margin, plus
// the reach test: 32 (i, j) tests per thread per staged tile (~10
// instructions each and one vote), one barrier more than fused_count.cu
// per entry.  On the TPU, `lax.cond` on a reduced flag cost 50-80 cycles
// per group; here the flags are computed once per staged tile into 16
// words of shared memory, and each group's test is a broadcast read.

#include <cuda_bf16.h>

#include "count_tile.cuh"

namespace {

using namespace rustsasa;

enum Variant {
  kBase = 0, kNoGroupCond, kJSkip, kGroup4, kNoCond, kBf16, kBf16P, kVariants
};

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// row_margins with the dot in bf16 (sx, sy, sz already rounded to bf16),
// v' = bf(v):
//   bf16p: dot = bf(bf(sx*vx') + bf(bf(sy*vy') + bf(sz*vz'))),
//          margin = bf(bf(lim) - dot);
//   bf16:  the same dot without its last rounding, margin = lim - dot in
//          f32.  The script converts the bf16 sum straight to f32, and
//          XLA drops that add's round trip through bf16 (measured on its
//          CPU backend: 0 of 13,312 values differ this way, 7,186 with
//          the rounding kept).
template <int K, bool kMarginBf16>
__device__ __forceinline__ void row_margins_bf16(float vx, float vy, float vz,
                                                 float lim,
                                                 const float (&sx)[K],
                                                 const float (&sy)[K],
                                                 const float (&sz)[K],
                                                 float (&occ)[K]) {
  const float bx = bf(vx), by = bf(vy), bz = bf(vz);
  const float blim = kMarginBf16 ? bf(lim) : lim;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float sum = __fadd_rn(
        bf(__fmul_rn(sx[k], bx)),
        bf(__fadd_rn(bf(__fmul_rn(sy[k], by)), bf(__fmul_rn(sz[k], bz)))));
    const float dot = kMarginBf16 ? bf(sum) : sum;
    const float margin = __fsub_rn(blim, dot);
    occ[k] = fmaxf(occ[k], kMarginBf16 ? bf(margin) : margin);
  }
}

template <int K, int V>
__global__ void __launch_bounds__(kThreads, 1)
reach_count_kernel(const float* __restrict__ planes,   // [8, m]
                   const int32_t* __restrict__ jlist,  // [m/128, 128]
                   const float4* __restrict__ sphere,  // [p]
                   int32_t* __restrict__ out,          // [m]
                   int32_t* __restrict__ executed,     // [m/128]
                   int m, int p, int passes) {
  constexpr bool kBf = V == kBf16 || V == kBf16P;
  constexpr bool kPerRow = V == kJSkip || V == kGroup4;
  constexpr int kGroup = V == kGroup4 ? 4 : kJGroup;
  constexpr uint32_t kGroupBits = (1u << kGroup) - 1u;

  extern __shared__ float4 smem[];
  const int n_cover = passes * kSlices * K;
  float4* sph = smem;
  float* jrec = reinterpret_cast<float*>(smem + n_cover);
  int* cnt = reinterpret_cast<int*>(jrec + kRecords * kAtomTile);
  uint32_t* hit = reinterpret_cast<uint32_t*>(cnt + kAtomTile);

  const int tid = threadIdx.x;
  const int a = tid % kAtomTile;
  const int slice = tid / kAtomTile;
  const int tile = blockIdx.x;
  const int n_tiles = m / kAtomTile;
  const int64_t mm = m;
  const int64_t i = static_cast<int64_t>(tile) * kAtomTile + a;

  stage_sphere(sph, sphere, p, n_cover);
  if (tid < kAtomTile) cnt[tid] = 0;
  const IAtom at = load_i_atom(planes, mm, i);

  const int32_t* row = jlist + static_cast<int64_t>(tile) * kJlistRows;
  const int n_entries = min(max(row[0], 0), kJlistRows - 1);
  int accessible = 0;
  int n_executed = 0;

  for (int pass = 0; pass < passes; ++pass) {
    __syncthreads();  // sphere and counters staged
    const int p0 = (pass * kSlices + slice) * K;
    float sx[K], sy[K], sz[K], occ[K];
    // Only the sign of the running max is read, so the valid points'
    // -1e30 start serves bf16p's bf16 max as well.
    load_points<K>(sph, p0, kNegBig, sx, sy, sz, occ);
    if (kBf) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sx[k] = bf(sx[k]);
        sy[k] = bf(sy[k]);
        sz[k] = bf(sz[k]);
      }
    }
    for (int e = 0; e < n_entries; ++e) {
      const int jt = static_cast<int>(static_cast<uint32_t>(row[1 + e]) &
                                      0xFFFFu);
      if (jt >= n_tiles) continue;  // uniform over the CTA
      load_j_tile(jrec, planes, mm, jt);
      if (V != kNoGroupCond) {
        publish_reach(hit, jrec, at, a, slice);
        __syncthreads();
      }
      for (int s = 0; s < kSlices; ++s) {
        const uint32_t word =
            V == kNoGroupCond ? 0xFFFFFFFFu : reach_rows(hit, s);
        for (int q = 0; q < 32 / kGroup; ++q) {
          const uint32_t gbits = (word >> (q * kGroup)) & kGroupBits;
          if (gbits == 0u) continue;  // uniform over the CTA
          const int row0 = s * 32 + q * kGroup;
#pragma unroll
          for (int r = 0; r < kGroup; ++r) {
            if (kPerRow && ((gbits >> r) & 1u) == 0u) continue;
            float vx, vy, vz;
            const float lim = row_lim(jrec, row0 + r, at, vx, vy, vz);
            if (kBf) {
              row_margins_bf16<K, V == kBf16P>(vx, vy, vz, lim, sx, sy, sz,
                                               occ);
            } else {
              row_margins<K>(vx, vy, vz, lim, sx, sy, sz, occ);
            }
          }
          if (tid == 0) n_executed += kPerRow ? __popc(gbits) : kGroup;
        }
      }
    }
    accessible += count_accessible<K>(sph, p0, occ);
  }
  write_count(cnt, a, slice, accessible, out, i);
  if (tid == 0) executed[tile] = n_executed;
}

// count_smem plus the 16 reach words.
inline size_t reach_smem(int passes, int k) {
  return count_smem(passes, k) + sizeof(uint32_t) * kReachWords;
}

template <int K, int V>
int launch_variant(const float* planes, const int32_t* jlist,
                   const float4* sphere, int32_t* out, int32_t* executed,
                   int m, int p, int passes, cudaStream_t stream) {
  reach_count_kernel<K, V>
      <<<m / kAtomTile, kThreads, reach_smem(passes, K), stream>>>(
          planes, jlist, sphere, out, executed, m, p, passes);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const float* planes, const int32_t* jlist, const float4* sphere,
           int32_t* out, int32_t* executed, int m, int p, int passes,
           int variant, cudaStream_t stream) {
#define RUSTSASA_REACH_CASE(V)                                              \
  case V:                                                                   \
    return launch_variant<K, V>(planes, jlist, sphere, out, executed, m, p, \
                                passes, stream);
  switch (variant) {
    RUSTSASA_REACH_CASE(kBase)
    RUSTSASA_REACH_CASE(kNoGroupCond)
    RUSTSASA_REACH_CASE(kJSkip)
    RUSTSASA_REACH_CASE(kGroup4)
    RUSTSASA_REACH_CASE(kNoCond)
    RUSTSASA_REACH_CASE(kBf16)
    RUSTSASA_REACH_CASE(kBf16P)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RUSTSASA_REACH_CASE
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  planes: f32
// [8, m] (rows x, y, z, r_eff, gid+1); jlist: i32 [m/128, 128]; sphere:
// f32 [p, 4]; out: i32 [m]; executed: i32 [m/128].  m is a positive
// multiple of 128, 0 < p <= 2048 and variant is 0-6 (base, nogroupcond,
// jskip, group4, nocond, bf16, bf16p).  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int reach_count_launch(const void* planes, const void* jlist,
                                  const void* sphere, void* out,
                                  void* executed, int m, int p, int variant,
                                  void* stream) {
  int passes, k;
  if (m <= 0 || m % kAtomTile != 0 || variant < 0 || variant >= kVariants ||
      !count_split(p, &passes, &k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RUSTSASA_SWITCH_K(
      k, launch<K>(static_cast<const float*>(planes),
                   static_cast<const int32_t*>(jlist),
                   static_cast<const float4*>(sphere),
                   static_cast<int32_t*>(out), static_cast<int32_t*>(executed),
                   m, p, passes, variant, static_cast<cudaStream_t>(stream)))
}
