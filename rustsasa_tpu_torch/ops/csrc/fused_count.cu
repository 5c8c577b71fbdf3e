// Occlusion-count kernel for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_fused_count_kernel`
// (rustsasa_tpu/ops/fused_kernel.py, launched by `_counts_call`).  For
// every i-atom of a 128-atom tile and every sphere point it takes the max
// over the admitted j-atoms of the occlusion margin
//     lim - dot,  v = c_i - c_j,  v2 = (vx*vx + vy*vy) + vz*vz,
//     lim = ((r_j*r_j - v2) - r_i*r_i) * (0.5 / max(r_i, 1e-6)),
//     dot = sx*vx + (sy*vy + sz*vz),
// with lim = -1e30 where gid_j == gid_i or gid_j == 0 (padding), and
// counts the valid points whose max is <= 0.  Admitted j-atoms are the
// 8-atom groups whose bit is set in a j-list entry (mask << 16) | j_tile.
//
// Bound: FP32 ALU throughput.  Each (point, i, j) triple costs 7 FP32
// instructions (3 mul, 2 add, 1 sub, 1 max) against no memory traffic:
// a j-tile's 128 x 5 records (2.5 KB) are read once per admitted entry
// and reused by all 128 x P (i, point) pairs of the tile.  The design
// keeps the ALUs fed and everything else off that path:
//   * one CTA per i-tile; 512 threads = 128 i-atoms x 4 point slices, a
//     warp being 32 i-atoms of one slice, so every shared-memory read of
//     a j-record or a sphere point is a broadcast;
//   * each thread keeps K <= 16 sphere points and their running max
//     margins in registers; the per-(i, j) setup (v, v2, lim, gid mask:
//     ~15 instructions) is amortized over K points; a sphere of more than
//     4 x 16 points is covered in passes, each re-streaming the j-list;
//   * the j-tile is staged in shared memory and only mask-admitted groups
//     are streamed (uniform across the CTA, so no divergence).
// Counts must equal the reference bit for bit, so every operation is an
// explicitly rounded __f*_rn intrinsic (no FMA contraction), in the
// reference's order; the library is also built with --fmad=false.
// Double-buffered TMA loads and wgmma are not used: the margin is not a
// matrix product, and the loads are not on the critical path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAtomTile = 128;
constexpr int kJlistRows = 128;
constexpr int kJGroup = 8;
constexpr int kRecords = 5;  // x, y, z, r_eff, gid
constexpr int kSlices = 4;
constexpr int kThreads = kAtomTile * kSlices;
constexpr int kMaxK = 16;
constexpr int kMaxPPad = 2048;
constexpr float kNegBig = -1e30f;

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
fused_count_kernel(const float* __restrict__ planes,   // [8, m]
                   const int32_t* __restrict__ jlist,  // [m/128, 128]
                   const float4* __restrict__ sphere,  // [p] x, y, z, valid
                   int32_t* __restrict__ out,          // [m]
                   int m, int p, int passes) {
  extern __shared__ float4 smem[];
  const int n_cover = passes * kSlices * K;
  float4* sph = smem;                                       // [n_cover]
  float* jrec = reinterpret_cast<float*>(smem + n_cover);   // [5][128]
  int* cnt = reinterpret_cast<int*>(jrec + kRecords * kAtomTile);  // [128]

  const int tid = threadIdx.x;
  const int a = tid % kAtomTile;
  const int slice = tid / kAtomTile;
  const int tile = blockIdx.x;
  const int n_tiles = m / kAtomTile;
  const int64_t mm = m;
  const int64_t i = static_cast<int64_t>(tile) * kAtomTile + a;

  for (int q = tid; q < n_cover; q += kThreads) {
    sph[q] = q < p ? sphere[q] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid < kAtomTile) cnt[tid] = 0;

  const float xi = planes[0 * mm + i];
  const float yi = planes[1 * mm + i];
  const float zi = planes[2 * mm + i];
  const float ri = planes[3 * mm + i];
  const float gi = planes[4 * mm + i];
  const float r2i = __fmul_rn(ri, ri);
  const float inv2ri = __fdiv_rn(0.5f, fmaxf(ri, 1e-6f));

  const int32_t* row = jlist + static_cast<int64_t>(tile) * kJlistRows;
  const int n_entries = min(max(row[0], 0), kJlistRows - 1);
  int accessible = 0;

  for (int pass = 0; pass < passes; ++pass) {
    __syncthreads();  // sphere and counters staged
    const int p0 = (pass * kSlices + slice) * K;
    float sx[K], sy[K], sz[K], occ[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 s = sph[p0 + k];
      sx[k] = s.x;
      sy[k] = s.y;
      sz[k] = s.z;
      occ[k] = kNegBig;
    }
    for (int e = 0; e < n_entries; ++e) {
      const uint32_t entry = static_cast<uint32_t>(row[1 + e]);
      const int jt = static_cast<int>(entry & 0xFFFFu);
      uint32_t mask = entry >> 16;
      if (jt >= n_tiles || mask == 0u) continue;  // uniform over the CTA
      const int64_t jbase = static_cast<int64_t>(jt) * kAtomTile;
      __syncthreads();  // the previous j-tile is consumed
      for (int q = tid; q < kRecords * kAtomTile; q += kThreads) {
        jrec[q] = planes[(q / kAtomTile) * mm + jbase + (q % kAtomTile)];
      }
      __syncthreads();
      while (mask != 0u) {
        const int g = __ffs(mask) - 1;
        mask &= mask - 1u;
#pragma unroll
        for (int r = 0; r < kJGroup; ++r) {
          const int jj = g * kJGroup + r;
          const float xk = jrec[0 * kAtomTile + jj];
          const float yk = jrec[1 * kAtomTile + jj];
          const float zk = jrec[2 * kAtomTile + jj];
          const float rk = jrec[3 * kAtomTile + jj];
          const float gk = jrec[4 * kAtomTile + jj];
          const float vx = __fsub_rn(xi, xk);
          const float vy = __fsub_rn(yi, yk);
          const float vz = __fsub_rn(zi, zk);
          const float v2 = __fadd_rn(
              __fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)),
              __fmul_rn(vz, vz));
          float lim = __fmul_rn(
              __fsub_rn(__fsub_rn(__fmul_rn(rk, rk), v2), r2i), inv2ri);
          if (gi == gk || gk == 0.0f) lim = kNegBig;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float dot = __fadd_rn(
                __fmul_rn(sx[k], vx),
                __fadd_rn(__fmul_rn(sy[k], vy), __fmul_rn(sz[k], vz)));
            occ[k] = fmaxf(occ[k], __fsub_rn(lim, dot));
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      accessible += (occ[k] <= 0.0f && sph[p0 + k].w > 0.0f) ? 1 : 0;
    }
  }
  atomicAdd(&cnt[a], accessible);
  __syncthreads();
  if (slice == 0) out[i] = cnt[a];
}

template <int K>
int launch(const float* planes, const int32_t* jlist, const float4* sphere,
           int32_t* out, int m, int p, int passes, cudaStream_t stream) {
  const size_t smem = sizeof(float4) * passes * kSlices * K +
                      sizeof(float) * kRecords * kAtomTile +
                      sizeof(int) * kAtomTile;
  fused_count_kernel<K><<<m / kAtomTile, kThreads, smem, stream>>>(
      planes, jlist, sphere, out, m, p, passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  planes: f32
// [8, m] (rows x, y, z, r_eff, gid+1); jlist: i32 [m/128, 128]; sphere:
// f32 [p, 4]; out: i32 [m].  m is a positive multiple of 128 and
// 0 < p <= 2048.  Returns the cudaError_t of the launch (0 = success).
extern "C" int fused_count_launch(const void* planes, const void* jlist,
                                  const void* sphere, void* out, int m,
                                  int p, void* stream) {
  if (m <= 0 || m % kAtomTile != 0 || p <= 0 || p > kMaxPPad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Fewest passes of 4 x kMaxK points, then the smallest K covering p.
  const int passes = (p + kSlices * kMaxK - 1) / (kSlices * kMaxK);
  const int k = (p + kSlices * passes - 1) / (kSlices * passes);
  const auto* pl = static_cast<const float*>(planes);
  const auto* jl = static_cast<const int32_t*>(jlist);
  const auto* sp = static_cast<const float4*>(sphere);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define RUSTSASA_CASE(K) \
  case K:                \
    return launch<K>(pl, jl, sp, o, m, p, passes, s);
    RUSTSASA_CASE(1) RUSTSASA_CASE(2) RUSTSASA_CASE(3) RUSTSASA_CASE(4)
    RUSTSASA_CASE(5) RUSTSASA_CASE(6) RUSTSASA_CASE(7) RUSTSASA_CASE(8)
    RUSTSASA_CASE(9) RUSTSASA_CASE(10) RUSTSASA_CASE(11) RUSTSASA_CASE(12)
    RUSTSASA_CASE(13) RUSTSASA_CASE(14) RUSTSASA_CASE(15) RUSTSASA_CASE(16)
#undef RUSTSASA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
