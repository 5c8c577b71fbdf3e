// Reach-test variants of the occlusion-count kernel for NVIDIA Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel built by `make_kernel(variant)`
// (scripts/r3_kernel_variants.py:54, launched by `run_variant_counts`).
// It predates group masks: every live j-list entry (j_tile = entry &
// 0xFFFF below the chunk's tile count; mask bits are ignored) stands for
// its whole j-tile, and a reach test on the tile's rows, not a host mask,
// decides what is computed.  Row jj of an entry's j-tile is in reach when
// v2 - (r_i + r_j)^2 < 0 for some of the i-tile's 128 atoms, padding
// lanes included.  A variant's rule is the set of rows whose margins join
// the running max:
//   base, nocond   the 8-row groups with a row in reach;
//   jskip, group4  the rows in reach (group4 is jskip over 4-row groups,
//                  which takes the same rows);
//   nogroupcond    every row (no test);
//   bf16, bf16p    as base, with bf16 arithmetic (row_margins_bf16).
// executed[tile] is the rule's rows over the live entries times
// count_tile.cuh's point passes (count_split), whatever split the count
// kernel runs.
//
// Design: a launch is two kernels on the caller's stream.
//  1. reach_rule_kernel, one CTA an i-tile, writes each live entry's rule
//     as four 32-row words, rule[tile][e][c] (e the entry's j-list
//     position), and executed[tile].  The tile-wide test needs all 128
//     atoms, where a count CTA holds 32, so it runs here once a (tile,
//     entry) and not in each of the four count CTAs and point passes.
//     Thread (slot, row) takes row `row` of entries slot, slot + 2, ...:
//     against the tile's bounding box, then each 8-atom group's box
//     (box_far, below), then the 8 atoms of each group it may reach, in
//     the reference's rounding, until its first hit.
//  2. reach_count_kernel, on kernel 1's layout (reach_ring.cuh: 4 CTAs of
//     32 atoms a tile, no cluster; 16 lanes an atom, lane_passes; the
//     bulk-copy ring; every entry with j_tile below the tile count live).
//     A chunk whose rule word is 0 is skipped; in the others lane l tests
//     its row where the rule holds (keep_row), and a ballot gives the
//     rows the warp streams: the rule's rows that one of its two atoms
//     keeps.  A row outside the rule is never streamed, even where
//     keep_row would keep it (rows inside kReachSlack of tangency need
//     not be in reach).  keep_row drops a row only where all its rounded
//     margins are <= 0 and keeps padding atoms' rows, so counts equal the
//     plain version's at every slot.  bf16 and bf16p drop rows by
//     keep_row's bf16 slack (kBf16Slack, derived in count_tile.cuh); the
//     five f32 variants share one count instantiation.
//
// box_far, the rule kernel's skip.  A box holds atoms a (x_a in [lo, hi]
// per axis, r_a <= rmax).  For a j-row at x_j: the gap g'_x = max(fl(lo -
// x_j), fl(x_j - hi), 0) is within (1 + u) of the exact distance from x_j
// to [lo, hi] (u = 2^-24), which is at most |x_a - x_j|, so d2' =
// fl(fl(g'_x^2 + g'_y^2) + g'_z^2) <= |x_a - x_j|^2 (1 + u)^5 while the
// test's v2' >= |x_a - x_j|^2 (1 - u)^5, i.e. v2' >= d2' (1 - 10.01u).
// Rounding is monotonic, so (r_a + r_j) and its square round to at most
// R2' = fl(fl(rmax + r_j)^2), and a hit needs v2' < R2'.  box_far asks
// d2' >= max(fl(R2' (1 + 2^-16)), 2^-100): then v2' >= R2' (1 + 2^-16)
// (1 - u)(1 - 10.01u) > R2' (2^-16 = 256u), or, where R2' (1 + 2^-16)
// < 2^-100, v2' > 2^-101 > R2'; the floor keeps subnormal roundings
// (absolute, below 2^-146) out of the way.  No atom of the box is in
// reach, so skipping its tests changes no rule word.
//
// Bound: FP32 issue, as fused_count.cu, on the work the inputs need
// (chip_smoke.recount_bound): the rows the count kernel streams are the
// rule's within kernel 1's reach skip, and the rule kernel's tests are
// the difference.

#include <cuda_bf16.h>

#include "reach_ring.cuh"

namespace {

using namespace rustsasa;

enum Variant {
  kBase = 0, kNoGroupCond, kJSkip, kGroup4, kNoCond, kBf16, kBf16P, kVariants
};
// A variant's rule (reach_rule_kernel) and arithmetic (reach_count_kernel).
enum Rule { kRuleGroups = 0, kRuleRows, kRuleAll };
enum Arith { kF32 = 0, kArithBf16, kArithBf16P };

constexpr int rule_of(int v) {
  return v == kNoGroupCond ? kRuleAll
         : (v == kJSkip || v == kGroup4) ? kRuleRows
                                         : kRuleGroups;
}

constexpr int arith_of(int v) {
  return v == kBf16 ? kArithBf16 : v == kBf16P ? kArithBf16P : kF32;
}

// ---- 1. the rule ----

constexpr int kRuleThreads = 256;
constexpr int kRuleSlots = kRuleThreads / kAtomTile;  // entries at a time
constexpr int kGroups = kAtomTile / kJGroup;
constexpr float kBoxSlack = 1.0f + 0x1p-16f;
constexpr float kBoxFloor = 0x1p-100f;

// Corners and largest r_eff of a set of atoms.
struct Box {
  float lx, ly, lz, hx, hy, hz, rmax, pad;
};

__device__ __forceinline__ Box box_merge(Box b, int off) {
  b.lx = fminf(b.lx, __shfl_xor_sync(kFullWarp, b.lx, off));
  b.ly = fminf(b.ly, __shfl_xor_sync(kFullWarp, b.ly, off));
  b.lz = fminf(b.lz, __shfl_xor_sync(kFullWarp, b.lz, off));
  b.hx = fmaxf(b.hx, __shfl_xor_sync(kFullWarp, b.hx, off));
  b.hy = fmaxf(b.hy, __shfl_xor_sync(kFullWarp, b.hy, off));
  b.hz = fmaxf(b.hz, __shfl_xor_sync(kFullWarp, b.hz, off));
  b.rmax = fmaxf(b.rmax, __shfl_xor_sync(kFullWarp, b.rmax, off));
  return b;
}

__device__ __forceinline__ float box_gap(float lo, float hi, float x) {
  return fmaxf(fmaxf(__fsub_rn(lo, x), __fsub_rn(x, hi)), 0.0f);
}

// True where no atom of box b can have the j-row in reach (derived in the
// header).
__device__ __forceinline__ bool box_far(const Box& b, float jx, float jy,
                                        float jz, float jr) {
  const float gx = box_gap(b.lx, b.hx, jx);
  const float gy = box_gap(b.ly, b.hy, jy);
  const float gz = box_gap(b.lz, b.hz, jz);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                             __fmul_rn(gz, gz));
  const float reach = __fadd_rn(b.rmax, jr);
  return d2 >= fmaxf(__fmul_rn(__fmul_rn(reach, reach), kBoxSlack),
                     kBoxFloor);
}

// The reference's reach test of i-atom a (x, y, z, r_eff) and the j-row:
// v = c_i - c_j, v2 = (vx*vx + vy*vy) + vz*vz, v2 - (r_i + r_j)^2 < 0.
__device__ __forceinline__ bool atom_reach(float4 a, float jx, float jy,
                                           float jz, float jr) {
  const float vx = __fsub_rn(a.x, jx);
  const float vy = __fsub_rn(a.y, jy);
  const float vz = __fsub_rn(a.z, jz);
  const float v2 = __fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)),
                             __fmul_rn(vz, vz));
  const float reach = __fadd_rn(a.w, jr);
  return __fsub_rn(v2, __fmul_rn(reach, reach)) < 0.0f;
}

// Each 8-bit group of w with a bit set, all set.
__device__ __forceinline__ uint32_t expand_groups(uint32_t w) {
  uint32_t g = w | (w >> 1);
  g |= g >> 2;
  g |= g >> 4;
  return (g & 0x01010101u) * 0xFFu;
}

template <int R>
__global__ void __launch_bounds__(kRuleThreads)
reach_rule_kernel(const float* __restrict__ planes,   // [8, m]
                  const int32_t* __restrict__ jlist,  // [m/128, 128]
                  uint32_t* __restrict__ rule,        // [m/128, 128, 4]
                  int32_t* __restrict__ executed,     // [m/128]
                  int m, int exec_passes) {
  __shared__ float4 atoms[kAtomTile];
  __shared__ Box boxes[kGroups + 1];  // the groups', then the tile's
  __shared__ int n_rows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tile = blockIdx.x;
  const int n_tiles = m / kAtomTile;
  const int64_t mm = m;
  const int32_t* row = jlist + static_cast<int64_t>(tile) * kJlistRows;
  const int n_entries = min(max(row[0], 0), kJlistRows - 1);

  if (tid == 0) n_rows = 0;
  if (R != kRuleAll && tid < kAtomTile) {
    const int64_t i = static_cast<int64_t>(tile) * kAtomTile + tid;
    const float4 a = make_float4(planes[i], planes[mm + i], planes[2 * mm + i],
                                 planes[3 * mm + i]);
    atoms[tid] = a;
    Box b{a.x, a.y, a.z, a.x, a.y, a.z, a.w, 0.0f};
#pragma unroll
    for (int off = 1; off < kJGroup; off <<= 1) b = box_merge(b, off);
    if ((tid & (kJGroup - 1)) == 0) boxes[tid / kJGroup] = b;
  }
  __syncthreads();
  if (R != kRuleAll && tid < 32) {
    Box b = boxes[lane & (kGroups - 1)];
#pragma unroll
    for (int off = 1; off < kGroups; off <<= 1) b = box_merge(b, off);
    if (lane == 0) boxes[kGroups] = b;
  }
  __syncthreads();

  const int r = tid % kAtomTile;
  int n = 0;
  for (int e = tid / kAtomTile; e < n_entries; e += kRuleSlots) {
    const int jt = static_cast<int>(static_cast<uint32_t>(row[1 + e]) &
                                    0xFFFFu);
    if (jt >= n_tiles) continue;  // uniform over the slot's four warps
    uint32_t word = kFullWarp;
    if (R != kRuleAll) {
      const int64_t j = static_cast<int64_t>(jt) * kAtomTile + r;
      const float jx = planes[j];
      const float jy = planes[mm + j];
      const float jz = planes[2 * mm + j];
      const float jr = planes[3 * mm + j];
      bool hit = false;
      if (!box_far(boxes[kGroups], jx, jy, jz, jr)) {
        for (int g = 0; g < kGroups && !hit; ++g) {
          if (box_far(boxes[g], jx, jy, jz, jr)) continue;
#pragma unroll
          for (int a = 0; a < kJGroup; ++a) {
            hit |= atom_reach(atoms[g * kJGroup + a], jx, jy, jz, jr);
          }
        }
      }
      word = __ballot_sync(kFullWarp, hit);
      if (R == kRuleGroups) word = expand_groups(word);
    }
    if (lane == 0) {
      rule[(static_cast<int64_t>(tile) * kJlistRows + e) * 4 + r / 32] = word;
      n += __popc(word);
    }
  }
  if (lane == 0 && n != 0) atomicAdd(&n_rows, n);
  __syncthreads();
  if (tid == 0) executed[tile] = exec_passes * n_rows;
}

// ---- 2. the counts ----

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
// Each operation is done in f32 (exact for a product of two bf16 values)
// and rounded by __float2bfloat16_rn, which for one operation gives the
// correctly rounded bf16 result, as torch's bf16 elementwise ops do.
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

// Shared memory after the ring's: the live entries' j-list positions,
// their rule words, the sphere.
constexpr int kPosOffset = kRingSmemEnd;
constexpr int kWordsOffset = kPosOffset + kJlistRows;
constexpr int kSphereOffset = kWordsOffset + 16 * kJlistRows;
static_assert(kWordsOffset % 16 == 0, "uint4 arrays need 16-byte alignment");

template <int K, int A>
__global__ void __launch_bounds__(32 * kLanes, min_ctas(K))
reach_count_kernel(const float* __restrict__ planes,   // [8, m]
                   const int32_t* __restrict__ jlist,  // [m/128, 128]
                   const uint4* __restrict__ rule,     // [m/128, 128]
                   const float4* __restrict__ sphere,  // [p]
                   int32_t* __restrict__ out,          // [m]
                   int m, int p, int passes) {
  constexpr int L = kLanes;
  constexpr int kTest = A == kF32 ? kKeepRow : kKeepRowBf16;
  extern __shared__ __align__(128) unsigned char smem[];
  const RingSmem sm = ring_smem(smem);
  uint8_t* pos = smem + kPosOffset;
  uint4* words = reinterpret_cast<uint4*>(smem + kWordsOffset);
  float4* sph = reinterpret_cast<float4*>(smem + kSphereOffset);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int a_local = lane / L;
  const int q = lane % L;
  const int tile = blockIdx.x / kQuarters;
  const int n_tiles = m / kAtomTile;
  const int64_t mm = m;
  const int64_t atom0 = static_cast<int64_t>(tile) * kAtomTile +
                        (blockIdx.x % kQuarters) * kCtaAtoms;
  const int n_cover = passes * L * K;

  // Staging: every entry on a tile of the chunk is live, mask or not;
  // its rule words by its j-list position.
  if (warp == 0) {
    const int32_t* row = jlist + static_cast<int64_t>(tile) * kJlistRows;
    stage_entries<true, true>(sm, pos, row,
                              min(max(row[0], 0), kJlistRows - 1), n_tiles,
                              lane);
    __syncwarp();
    const int n = *sm.n_live;
    for (int i = lane; i < n; i += 32) {
      words[i] = rule[static_cast<int64_t>(tile) * kJlistRows + pos[i]];
    }
  }
  stage_atoms(sm, planes, mm, atom0, tid);
  const bool far_ok =
      __syncthreads_and(stage_sphere_norms(sph, sphere, p, n_cover, tid)) != 0;
  const int n_live = *sm.n_live;
  const int total = passes * n_live;
  const int cta_atom = warp * kWarpAtoms + a_local;
  const IAtom at = load_i_atom(planes, mm, atom0 + cta_atom);

  int next = 0;  // the producer's next load
  int g = 0;     // this warp's load
  int accessible = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int p0 = (pass * L + q) * K;
    float sx[K], sy[K], sz[K], occ[K];
    // Only the sign of the running max is read, so the valid points'
    // -1e30 start serves bf16p's bf16 max as well.
    load_points<K>(sph, p0, kNegBig, sx, sy, sz, occ);
    if (A != kF32) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sx[k] = bf(sx[k]);
        sy[k] = bf(sy[k]);
        sz[k] = bf(sz[k]);
      }
    }
    for (int e = 0; e < n_live; ++e, ++g) {
      const int s = g % kRing;
      if (tid == 0) {
        next = produce<false>(g, next, total, sm, n_live, planes, mm,
                              nullptr);
      }
      __syncwarp();
      bar_wait(&sm.full[s], (g / kRing) & 1);
      const float* jrec = sm.slots + s * kTileFloats;
      const uint32_t* w = reinterpret_cast<const uint32_t*>(words + e);
#pragma unroll 1
      for (int c = 0; c < kAtomTile / 32; ++c) {
        const uint32_t rw = w[c];
        if (rw == 0u) continue;  // uniform over the warp
        const ChunkRows rows{c};
        const uint32_t keep = rows_keep<kTest>(
            jrec, rows, ((rw >> lane) & 1u) != 0u, sm, warp, lane, far_ok);
        uint32_t u = __ballot_sync(kFullWarp, keep != 0u);
        if (A == kF32) {
          stream_rows<K>(u, keep, jrec, rows, a_local, at, sx, sy, sz, occ);
        } else {
          while (u != 0u) {  // uniform over the warp
            const int b = __ffs(u) - 1;
            u &= u - 1u;
            float vx, vy, vz;
            const float lim =
                rows_lim(jrec, rows, b, keep, a_local, at, vx, vy, vz);
            row_margins_bf16<K, A == kArithBf16P>(vx, vy, vz, lim, sx, sy,
                                                  sz, occ);
          }
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&sm.empty[s]);
    }
    accessible += count_accessible<K>(sph, p0, occ);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    accessible += __shfl_xor_sync(kFullWarp, accessible, off);
  }
  if (q == 0) out[atom0 + cta_atom] = accessible;
}

template <int R>
int launch_rule(const float* planes, const int32_t* jlist, uint32_t* rule,
                int32_t* executed, int m, int exec_passes,
                cudaStream_t stream) {
  reach_rule_kernel<R><<<m / kAtomTile, kRuleThreads, 0, stream>>>(
      planes, jlist, rule, executed, m, exec_passes);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int A>
int launch_count(const float* planes, const int32_t* jlist, const uint4* rule,
                 const float4* sphere, int32_t* out, int m, int p, int passes,
                 cudaStream_t stream) {
  const int smem = kSphereOffset + 16 * passes * kLanes * K;
  auto kernel = reach_count_kernel<K, A>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  }
  kernel<<<(m / kAtomTile) * kQuarters, 32 * kLanes, smem, stream>>>(
      planes, jlist, rule, sphere, out, m, p, passes);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_arith(const float* planes, const int32_t* jlist, const uint4* rule,
                 const float4* sphere, int32_t* out, int m, int p, int passes,
                 int arith, cudaStream_t stream) {
  switch (arith) {
    case kF32:
      return launch_count<K, kF32>(planes, jlist, rule, sphere, out, m, p,
                                   passes, stream);
    case kArithBf16:
      return launch_count<K, kArithBf16>(planes, jlist, rule, sphere, out, m,
                                         p, passes, stream);
    default:
      return launch_count<K, kArithBf16P>(planes, jlist, rule, sphere, out,
                                          m, p, passes, stream);
  }
}

}  // namespace

// Launches the two kernels on `stream` without synchronizing.  planes:
// f32 [8, m] (rows x, y, z, r_eff, gid+1), 16-byte aligned; jlist: i32
// [m/128, 128]; sphere: f32 [p, 4]; out: i32 [m]; executed: i32 [m/128];
// rule: i32 [m/128, 128, 4], scratch for the rule words.  m is a positive
// multiple of 128, 0 < p <= 2048 and variant is 0-6 (base, nogroupcond,
// jskip, group4, nocond, bf16, bf16p).  Returns the cudaError_t of the
// launches (0 = success).
// As reach_count_launch's first kernel alone: rule and executed for
// variant, p the sphere's points (for executed's passes).  For timing the
// rule kernel (chip_smoke.py); the studies run reach_count_launch.
extern "C" int reach_rule_launch(const void* planes, const void* jlist,
                                 void* executed, void* rule, int m, int p,
                                 int variant, void* stream) {
  int exec_passes, exec_k;
  if (m <= 0 || m % kAtomTile != 0 || variant < 0 || variant >= kVariants ||
      !count_split(p, &exec_passes, &exec_k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* pl = static_cast<const float*>(planes);
  const auto* jl = static_cast<const int32_t*>(jlist);
  auto* rw = static_cast<uint32_t*>(rule);
  auto* ex = static_cast<int32_t*>(executed);
  auto* st = static_cast<cudaStream_t>(stream);
  switch (rule_of(variant)) {
    case kRuleAll:
      return launch_rule<kRuleAll>(pl, jl, rw, ex, m, exec_passes, st);
    case kRuleRows:
      return launch_rule<kRuleRows>(pl, jl, rw, ex, m, exec_passes, st);
    default:
      return launch_rule<kRuleGroups>(pl, jl, rw, ex, m, exec_passes, st);
  }
}

extern "C" int reach_count_launch(const void* planes, const void* jlist,
                                  const void* sphere, void* out,
                                  void* executed, void* rule, int m, int p,
                                  int variant, void* stream) {
  if (reinterpret_cast<uintptr_t>(planes) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = reach_rule_launch(planes, jlist, executed, rule, m, p,
                                   variant, stream);
  if (rc != 0) return rc;
  const auto* pl = static_cast<const float*>(planes);
  const auto* jl = static_cast<const int32_t*>(jlist);
  auto* rw = static_cast<uint32_t*>(rule);
  auto* st = static_cast<cudaStream_t>(stream);
  const int passes = (p + kLanes * kMaxK - 1) / (kLanes * kMaxK);
  const int k = (p + kLanes * passes - 1) / (kLanes * passes);
  const int arith = arith_of(variant);
  RUSTSASA_SWITCH_K(
      k, launch_arith<K>(pl, jl, reinterpret_cast<const uint4*>(rw),
                         static_cast<const float4*>(sphere),
                         static_cast<int32_t*>(out), m, p, passes, arith, st))
}
