// Shared pieces of the occlusion-count kernels (fused_count.cu and its
// variants pair64_count.cu, nibble_count.cu, saturation_count.cu,
// micro_count.cu, reach_count.cu, maxplus_count.cu), for NVIDIA Hopper
// (sm_90a).
//
// The variants keep fused_count.cu's layout and arithmetic and change
// only which j-groups a thread streams, or when a CTA stops
// (maxplus_count.cu takes its own thread layout and shares only the
// constants, IAtom, load_i_atom, stage_sphere and RUSTSASA_SWITCH_K):
//   * one CTA per 128-atom i-tile; 512 threads = 128 i-atoms x 4 point
//     slices, a warp being 32 consecutive i-atoms of one slice (thread
//     tid owns atom tid % 128 of slice tid / 128; pair64_count.cu places
//     the warps otherwise), so atoms 0-63 and 64-127 are whole warps;
//   * K <= 16 sphere points per thread in registers, a sphere of more
//     than 4 x 16 points covered in passes (pass q holds points
//     [q*4*K, (q+1)*4*K), see count_split);
//   * an admitted j-tile's 5 x 128 records staged in shared memory;
//   * every operation an explicitly rounded __f*_rn intrinsic in the
//     reference's order, so counts equal the reference bit for bit.
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

// j-tile jt's records into shared memory, bracketed by the barriers that
// keep the previous tile until it is consumed and publish this one.
__device__ __forceinline__ void load_j_tile(float* jrec,
                                            const float* __restrict__ planes,
                                            int64_t mm, int jt) {
  const int64_t jbase = static_cast<int64_t>(jt) * kAtomTile;
  __syncthreads();
  for (int q = threadIdx.x; q < kRecords * kAtomTile; q += kThreads) {
    jrec[q] = planes[(q / kAtomTile) * mm + jbase + (q % kAtomTile)];
  }
  __syncthreads();
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

// Sums atom a's accessible points over the slices into out[i]; every
// thread of the CTA calls it once, after its last pass.
__device__ __forceinline__ void write_count(int* cnt, int a, int slice,
                                            int accessible,
                                            int32_t* __restrict__ out,
                                            int64_t i) {
  atomicAdd(&cnt[a], accessible);
  __syncthreads();
  if (slice == 0) out[i] = cnt[a];
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

// Max-accumulates the margins of j-row jj of the staged tile into occ.
template <int K>
__device__ __forceinline__ void stream_row(const float* jrec, int jj,
                                           const IAtom& at,
                                           const float (&sx)[K],
                                           const float (&sy)[K],
                                           const float (&sz)[K],
                                           float (&occ)[K]) {
  float vx, vy, vz;
  const float lim = row_lim(jrec, jj, at, vx, vy, vz);
  row_margins<K>(vx, vy, vz, lim, sx, sy, sz, occ);
}

// Max-accumulates the margins of the 8 j-atoms of group g into occ.
template <int K>
__device__ __forceinline__ void stream_group(const float* jrec, int g,
                                             const IAtom& at,
                                             const float (&sx)[K],
                                             const float (&sy)[K],
                                             const float (&sz)[K],
                                             float (&occ)[K]) {
#pragma unroll
  for (int r = 0; r < kJGroup; ++r) {
    stream_row<K>(jrec, g * kJGroup + r, at, sx, sy, sz, occ);
  }
}

// Reach test of the reference scripts: v2 - (r_i + r_j)^2 < 0, i.e. the
// r_eff spheres of atom `at` and j-row jj overlap.
__device__ __forceinline__ bool in_reach(const float* jrec, int jj,
                                         const IAtom& at) {
  float vx, vy, vz;
  const float v2 = row_v(jrec, jj, at, vx, vy, vz);
  const float reach = __fadd_rn(at.r, jrec[3 * kAtomTile + jj]);
  return __fsub_rn(v2, __fmul_rn(reach, reach)) < 0.0f;
}

// The rows of the staged j-tile that some of the tile's 128 atoms reach,
// published CTA-uniformly.  Thread (a, slice) tests its atom against rows
// [32*slice, 32*slice + 32); each warp ORs its 32 atoms' answers per row
// (__any_sync) and stores the 32 row bits in hit[(a / 32) * 4 + slice].
// After a barrier, reach_rows(hit, s) ORs the four warps of slice s: bit
// r set iff row 32*s + r is in reach of some atom of the tile.
constexpr int kReachWords = kSlices * kAtomTile / 32;  // hit[] length

__device__ __forceinline__ void publish_reach(uint32_t* hit,
                                              const float* jrec,
                                              const IAtom& at, int a,
                                              int slice) {
  uint32_t bits = 0u;
#pragma unroll 4
  for (int r = 0; r < 32; ++r) {
    const bool h = in_reach(jrec, slice * 32 + r, at);
    bits |= static_cast<uint32_t>(__any_sync(0xFFFFFFFFu, h)) << r;
  }
  if ((a & 31) == 0) hit[(a / 32) * kSlices + slice] = bits;
}

__device__ __forceinline__ uint32_t reach_rows(const uint32_t* hit, int s) {
  return hit[s] | hit[kSlices + s] | hit[2 * kSlices + s] |
         hit[3 * kSlices + s];
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

// Dynamic shared memory: the padded sphere, one j-tile, 128 counters.
inline size_t count_smem(int passes, int k) {
  return sizeof(float4) * passes * kSlices * k +
         sizeof(float) * kRecords * kAtomTile + sizeof(int) * kAtomTile;
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
