// Max-plus occlusion-count kernel for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `mp_static_kernel` (scripts/r3_maxplus.py,
// launched by `run_variant(variant="mp_static")`).  Kernel 1's margin
//     lim_ij - s_p.(c_i - c_j)
// is split into a part per (j, i), one per (p, j) and one per (p, i):
//     (LIMT[j, i] + TJ[p, j]) - SXI[p, i],
//     SXI[p, i] = s_p.c_i,  TJ[p, j] = s_p.c_j,
//     LIMT[j, i] = ((r_j*r_j - v2t) - r_i*r_i) * (0.5 / max(r_i, 1e-6)),
//     v2t = (|c_j|^2 - 2 c_j.c_i) + |c_i|^2,
// LIMT = -1e30 where gid_j == gid_i or gid_j == 0.  SXI does not depend on
// j, so it leaves the max: a point is accessible when
//     max_j (LIMT[j, i] + TJ[p, j]) - SXI[p, i] <= 0.
// The script computes the K = 3 products (SXI, TJ, c_j.c_i) with
// dot_general at HIGHEST precision and the squared norms with sum(c*c);
// on XLA's CPU backend each is the left-to-right fused chain
//     fma(a2, b2, fma(a1, b1, a0*b0)),
// and so is it here (dot3), in the kernel's own body: no library product.
// Every other operation is a separately rounded __f*_rn intrinsic in the
// script's order, so the counts equal the plain version's bit for bit.
// They may differ from kernel 1's at boundary points (another rounding).
//
// Bound: FP32 issue.  Per margin 2 instructions (add, max) against kernel
// 1's 7; everything else is set-up per (i, j) or per (p, j), and the
// design keeps it off the margins:
//   * one CTA per 128-atom i-tile, 512 threads = 64 atom pairs (atoms a
//     and a + 64) x 8 point slices of K <= 16 points, so up to 128 points
//     (the corpus's 104) take one pass over the j-list; larger spheres
//     take passes of 128;
//   * per admitted j-list entry the CTA computes each LIMT[j, i] of the
//     admitted groups once (2 a thread: its row r = slice of a group, for
//     its two atoms) into shared memory as [group][j half][atom] float4,
//     which a thread reads back as two conflict-free LDS.128 per atom and
//     group, and each TJ[p, j] once, as [point][j] rows padded to 136
//     floats (a warp's stores of 4 points x 8 j fall on distinct banks;
//     the margin loop reads a group's 8 values as two broadcast LDS.128
//     per point, shared by the thread's two atoms);
//   * the next admitted entry's 5 x 128 j-records load with cp.async into
//     a second buffer while the current entry's set-up and margins run.
// That is 2 FP32 instructions and 1/8 of an LDS.128 per margin in the
// inner loop.  Shared memory (up to 170 KB: LIMT 64 KB, TJ 68 KB) holds
// one CTA per SM; two CTAs of 256 threads would need the same LIMT and TJ
// buffers each and do not fit.

#include "count_tile.cuh"

namespace {

using namespace rustsasa;

constexpr int kMpSlices = 8;
constexpr int kPairs = kAtomTile / 2;
constexpr int kMpThreads = kPairs * kMpSlices;
constexpr int kMpMaxK = 16;
constexpr int kGroups = kAtomTile / kJGroup;
// Pitch of a TJ row: 128 j + 8, so that a warp's 4 rows start on banks
// 0, 8, 16 and 24.
constexpr int kTjPitch = kAtomTile + kJGroup;
constexpr int kJRecFloats = kRecords * kAtomTile;
static_assert(kMpThreads == kThreads, "stage_sphere strides by kThreads");

// a0*b0 + a1*b1 + a2*b2 as XLA-CPU's K = 3 dot: fma(a2, b2, fma(a1, b1,
// a0*b0)).
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

// j-tile jt's 5 x 128 records into jrec, as 4-byte cp.async copies (the
// planes need no alignment beyond a float's) in one commit group.
__device__ __forceinline__ void prefetch_j_tile(float* jrec,
                                                const float* __restrict__ planes,
                                                int64_t mm, int jt) {
  const int64_t jbase = static_cast<int64_t>(jt) * kAtomTile;
  for (int q = threadIdx.x; q < kJRecFloats; q += kMpThreads) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(jrec + q));
    const float* src = planes + (q / kAtomTile) * mm + jbase + q % kAtomTile;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The first entry after e whose j-tile is in range and whose mask admits a
// group, or n; uniform over the CTA.
__device__ __forceinline__ int next_entry(const int* ents, int e, int n,
                                          int n_tiles) {
  for (++e; e < n; ++e) {
    const uint32_t entry = static_cast<uint32_t>(ents[e]);
    if (static_cast<int>(entry & 0xFFFFu) < n_tiles && (entry >> 16) != 0u) {
      break;
    }
  }
  return e;
}

template <int K>
__global__ void __launch_bounds__(kMpThreads, 1)
maxplus_count_kernel(const float* __restrict__ planes,   // [8, m]
                     const int32_t* __restrict__ jlist,  // [m/128, 128]
                     const float4* __restrict__ sphere,  // [p]
                     int32_t* __restrict__ out,          // [m]
                     int m, int p, int passes) {
  constexpr int kPassPoints = kMpSlices * K;
  extern __shared__ float4 smem[];
  const int n_cover = passes * kPassPoints;
  float4* sph = smem;                             // [n_cover]
  float4* limt = sph + n_cover;                   // [16][2][128]
  float* tj = reinterpret_cast<float*>(limt + kGroups * 2 * kAtomTile);
  float* jrec = tj + kPassPoints * kTjPitch;      // [2][5][128]
  int* ents = reinterpret_cast<int*>(jrec + 2 * kJRecFloats);  // [127]
  int* cnt = ents + kJlistRows;                   // [128]

  const int tid = threadIdx.x;
  const int pr = tid % kPairs;
  const int slice = tid / kPairs;
  const int tile = blockIdx.x;
  const int n_tiles = m / kAtomTile;
  const int64_t mm = m;
  const int64_t i0 = static_cast<int64_t>(tile) * kAtomTile + pr;
  const IAtom at[2] = {load_i_atom(planes, mm, i0),
                       load_i_atom(planes, mm, i0 + kPairs)};
  float ci2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ci2[h] = dot3(at[h].x, at[h].x, at[h].y, at[h].y, at[h].z, at[h].z);
  }

  stage_sphere(sph, sphere, p, n_cover);
  const int32_t* row = jlist + static_cast<int64_t>(tile) * kJlistRows;
  const int n_entries = min(max(row[0], 0), kJlistRows - 1);
  for (int q = tid; q < n_entries; q += kMpThreads) ents[q] = row[1 + q];
  if (tid < kAtomTile) cnt[tid] = 0;
  __syncthreads();

  int accessible[2] = {0, 0};
  for (int pass = 0; pass < passes; ++pass) {
    const float4* pts = sph + pass * kPassPoints;
    float occ[2][K];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < K; ++k) occ[h][k] = kNegBig;

    int e = next_entry(ents, -1, n_entries, n_tiles);
    int buf = 0;
    if (e < n_entries) prefetch_j_tile(jrec, planes, mm, ents[e] & 0xFFFF);
    while (e < n_entries) {
      const int e_next = next_entry(ents, e, n_entries, n_tiles);
      const uint32_t mask = static_cast<uint32_t>(ents[e]) >> 16;
      const float* jr = jrec + buf * kJRecFloats;
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      // Entry e's records have landed; entry e-1's LIMT and TJ are read.
      __syncthreads();
      if (e_next < n_entries) {
        prefetch_j_tile(jrec + (buf ^ 1) * kJRecFloats, planes, mm,
                        ents[e_next] & 0xFFFF);
      }
      // LIMT of row `slice` of each admitted group, for both atoms.
      for (uint32_t mk = mask; mk != 0u; mk &= mk - 1u) {
        const int g = __ffs(mk) - 1;
        const int jj = g * kJGroup + slice;
        const float xj = jr[0 * kAtomTile + jj];
        const float yj = jr[1 * kAtomTile + jj];
        const float zj = jr[2 * kAtomTile + jj];
        const float rj = jr[3 * kAtomTile + jj];
        const float gj = jr[4 * kAtomTile + jj];
        const float cj2 = dot3(xj, xj, yj, yj, zj, zj);
        const float rj2 = __fmul_rn(rj, rj);
        float* dst = reinterpret_cast<float*>(
                         limt + (g * 2 + slice / 4) * kAtomTile + pr) +
                     slice % 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float cji = dot3(xj, at[h].x, yj, at[h].y, zj, at[h].z);
          const float v2t =
              __fadd_rn(__fsub_rn(cj2, __fmul_rn(2.0f, cji)), ci2[h]);
          const float lim = __fmul_rn(
              __fsub_rn(__fsub_rn(rj2, v2t), at[h].r2), at[h].inv2r);
          dst[h * kPairs * 4] =
              (at[h].gid == gj || gj == 0.0f) ? kNegBig : lim;
        }
      }
      // TJ[p, j] of each admitted group's 8 rows for this pass's points.
      for (uint32_t mk = mask; mk != 0u; mk &= mk - 1u) {
        const int g = __ffs(mk) - 1;
        for (int q = tid; q < kPassPoints * kJGroup; q += kMpThreads) {
          const int pt = q / kJGroup;
          const int j = g * kJGroup + q % kJGroup;
          const float4 s = pts[pt];
          tj[pt * kTjPitch + j] =
              dot3(s.x, jr[j], s.y, jr[kAtomTile + j], s.z,
                   jr[2 * kAtomTile + j]);
        }
      }
      __syncthreads();
      for (uint32_t mk = mask; mk != 0u; mk &= mk - 1u) {
        const int g = __ffs(mk) - 1;
        float lim[2][kJGroup];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 l0 = limt[(g * 2) * kAtomTile + pr + h * kPairs];
          const float4 l1 = limt[(g * 2 + 1) * kAtomTile + pr + h * kPairs];
          lim[h][0] = l0.x; lim[h][1] = l0.y; lim[h][2] = l0.z; lim[h][3] = l0.w;
          lim[h][4] = l1.x; lim[h][5] = l1.y; lim[h][6] = l1.z; lim[h][7] = l1.w;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float4* t = reinterpret_cast<const float4*>(
              tj + (slice * K + k) * kTjPitch + g * kJGroup);
          const float4 t0 = t[0];
          const float4 t1 = t[1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float o = occ[h][k];
            o = fmaxf(o, __fadd_rn(lim[h][0], t0.x));
            o = fmaxf(o, __fadd_rn(lim[h][1], t0.y));
            o = fmaxf(o, __fadd_rn(lim[h][2], t0.z));
            o = fmaxf(o, __fadd_rn(lim[h][3], t0.w));
            o = fmaxf(o, __fadd_rn(lim[h][4], t1.x));
            o = fmaxf(o, __fadd_rn(lim[h][5], t1.y));
            o = fmaxf(o, __fadd_rn(lim[h][6], t1.z));
            occ[h][k] = fmaxf(o, __fadd_rn(lim[h][7], t1.w));
          }
        }
      }
      e = e_next;
      buf ^= 1;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int n = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 s = pts[slice * K + k];
        const float sxi = dot3(s.x, at[h].x, s.y, at[h].y, s.z, at[h].z);
        n += (__fsub_rn(occ[h][k], sxi) <= 0.0f && s.w > 0.0f) ? 1 : 0;
      }
      accessible[h] += n;
    }
  }
  atomicAdd(&cnt[pr], accessible[0]);
  atomicAdd(&cnt[pr + kPairs], accessible[1]);
  __syncthreads();
  if (tid < kAtomTile) out[static_cast<int64_t>(tile) * kAtomTile + tid] = cnt[tid];
}

// Fewest passes of 8 x 16 points, then the smallest K covering p; false
// when p is out of range.
inline bool maxplus_split(int p, int* passes, int* k) {
  if (p <= 0 || p > kMaxPPad) return false;
  *passes = (p + kMpSlices * kMpMaxK - 1) / (kMpSlices * kMpMaxK);
  *k = (p + kMpSlices * *passes - 1) / (kMpSlices * *passes);
  return true;
}

// The padded sphere, LIMT, one pass's TJ rows, two j-tiles, the j-list row
// and 128 counters.
inline size_t maxplus_smem(int passes, int k) {
  return sizeof(float4) * (passes * kMpSlices * k + kGroups * 2 * kAtomTile) +
         sizeof(float) * (kMpSlices * k * kTjPitch + 2 * kJRecFloats) +
         sizeof(int) * 2 * kJlistRows;
}

template <int K>
int launch(const float* planes, const int32_t* jlist, const float4* sphere,
           int32_t* out, int m, int p, int passes, cudaStream_t stream) {
  const size_t smem = maxplus_smem(passes, K);
  const cudaError_t set = cudaFuncSetAttribute(
      maxplus_count_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  maxplus_count_kernel<K><<<m / kAtomTile, kMpThreads, smem, stream>>>(
      planes, jlist, sphere, out, m, p, passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  planes: f32
// [8, m] (rows x, y, z, r_eff, gid+1); jlist: i32 [m/128, 128] with
// entries (mask << 16) | j_tile; sphere: f32 [p, 4]; out: i32 [m].  m is
// a positive multiple of 128 and 0 < p <= 2048.  Returns the cudaError_t
// of the launch (0 = success).
extern "C" int maxplus_count_launch(const void* planes, const void* jlist,
                                    const void* sphere, void* out, int m,
                                    int p, void* stream) {
  int passes, k;
  if (m <= 0 || m % kAtomTile != 0 || !maxplus_split(p, &passes, &k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RUSTSASA_SWITCH_K(
      k, launch<K>(static_cast<const float*>(planes),
                   static_cast<const int32_t*>(jlist),
                   static_cast<const float4*>(sphere),
                   static_cast<int32_t*>(out), m, p, passes,
                   static_cast<cudaStream_t>(stream)))
}
