// List-path occlusion kernel for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_occlusion_tile_kernel`
// (rustsasa_tpu/ops/pallas_kernel.py, launched by `occlusion_sasa_pallas`).
// Input: the neighbor phase's pre-gathered records, K-major,
//     vx, vy, vz, limit [kdim, n] f32  (v = c_i - c_k; limit = -1e30 on
//                                        slots that hold no neighbor),
// a per-atom area factor [n] f32, the sphere [p] float4 (x, y, z, valid)
// and a per-128-atom-tile neighbor bound tile_kmax.  Point s of atom i is
// occluded iff some k < tile_kmax[i / 128] has
//     (sx*vx + sy*vy) + sz*vz < limit,
// and the output is area[i] * (number of valid points not occluded).
//
// Bound: FP32 ALU throughput.  Each (point, atom, k) triple costs 6
// instructions (3 mul, 2 add, 1 compare-and-set); a neighbor record
// (16 B) is read from shared memory once per (atom, k) and reused by the
// K <= 16 points a thread keeps in registers.  The design:
//   * one CTA per 128-atom tile; 512 threads = 128 atoms x 4 point
//     slices, a warp being 32 atoms of one slice, so a staged record row
//     is read by consecutive threads from consecutive words;
//   * the tile's records are staged through shared memory 16 rows of k at
//     a time (32 KB), loaded coalesced from the K-major planes, and the
//     loop stops at the tile's own bound, uniform across the CTA;
//   * the occlusion of a thread's points is an OR-accumulated bit mask;
//   * no cap on the number of points: a sphere of more than 4 x 16 points
//     is covered in passes, each re-streaming the tile's records, so the
//     50,000-point analytic case runs here too.
// The result equals the plain version bit for bit: every product and sum
// is an explicitly rounded __f*_rn intrinsic in the reference's order, and
// the library is built with --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAtomTile = 128;
constexpr int kSlices = 4;
constexpr int kThreads = kAtomTile * kSlices;
constexpr int kMaxK = 16;
constexpr int kStageRows = 16;
constexpr float kNegBig = -1e30f;

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
list_occlusion_kernel(const float* __restrict__ vx,       // [kdim, n]
                      const float* __restrict__ vy,       // [kdim, n]
                      const float* __restrict__ vz,       // [kdim, n]
                      const float* __restrict__ lim,      // [kdim, n]
                      const float* __restrict__ area,     // [n]
                      const float4* __restrict__ sphere,  // [p]
                      const int32_t* __restrict__ tile_kmax,  // [tiles]
                      float* __restrict__ out,            // [n]
                      int n, int kdim, int p, int passes) {
  __shared__ float4 rows[kStageRows][kAtomTile];
  __shared__ int cnt[kAtomTile];

  const int tid = threadIdx.x;
  const int a = tid % kAtomTile;
  const int slice = tid / kAtomTile;
  const int64_t nn = n;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kAtomTile;
  const int kmax = min(max(tile_kmax[blockIdx.x], 0), kdim);

  if (tid < kAtomTile) cnt[tid] = 0;
  __syncthreads();

  int accessible = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int p0 = (pass * kSlices + slice) * K;
    float sx[K], sy[K], sz[K];
    uint32_t valid = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = p0 + k;
      const float4 s = q < p ? sphere[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      sx[k] = s.x;
      sy[k] = s.y;
      sz[k] = s.z;
      if (s.w > 0.0f) valid |= 1u << k;
    }
    uint32_t occ = 0u;
    for (int k0 = 0; k0 < kmax; k0 += kStageRows) {
      const int n_rows = min(kStageRows, kmax - k0);
      __syncthreads();  // the previous rows are consumed
      for (int q = tid; q < n_rows * kAtomTile; q += kThreads) {
        const int r = q / kAtomTile;
        const int c = q % kAtomTile;
        float4 rec = make_float4(0.f, 0.f, 0.f, kNegBig);
        if (base + c < nn) {
          const int64_t off = static_cast<int64_t>(k0 + r) * nn + base + c;
          rec = make_float4(vx[off], vy[off], vz[off], lim[off]);
        }
        rows[r][c] = rec;
      }
      __syncthreads();
      for (int r = 0; r < n_rows; ++r) {
        const float4 rec = rows[r][a];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float dot = __fadd_rn(
              __fadd_rn(__fmul_rn(sx[k], rec.x), __fmul_rn(sy[k], rec.y)),
              __fmul_rn(sz[k], rec.z));
          if (dot < rec.w) occ |= 1u << k;
        }
      }
    }
    accessible += __popc(valid & ~occ);
  }
  atomicAdd(&cnt[a], accessible);
  __syncthreads();
  if (slice == 0 && base + a < nn) {
    out[base + a] = __fmul_rn(static_cast<float>(cnt[a]), area[base + a]);
  }
}

template <int K>
int launch(const float* vx, const float* vy, const float* vz,
           const float* lim, const float* area, const float4* sphere,
           const int32_t* tile_kmax, float* out, int n, int kdim, int p,
           int passes, cudaStream_t stream) {
  const int tiles = (n + kAtomTile - 1) / kAtomTile;
  list_occlusion_kernel<K><<<tiles, kThreads, 0, stream>>>(
      vx, vy, vz, lim, area, sphere, tile_kmax, out, n, kdim, p, passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  vx, vy, vz,
// lim: f32 [kdim, n]; area: f32 [n]; sphere: f32 [p, 4]; tile_kmax: i32
// [ceil(n / 128)]; out: f32 [n].  n, kdim and p are positive.  Returns
// the cudaError_t of the launch (0 = success).
extern "C" int list_occlusion_launch(const void* vx, const void* vy,
                                     const void* vz, const void* lim,
                                     const void* area, const void* sphere,
                                     const void* tile_kmax, void* out, int n,
                                     int kdim, int p, void* stream) {
  if (n <= 0 || kdim <= 0 || p <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Fewest passes of 4 x kMaxK points, then the smallest K covering p.
  const int passes = (p + kSlices * kMaxK - 1) / (kSlices * kMaxK);
  const int k = (p + kSlices * passes - 1) / (kSlices * passes);
  const auto* x = static_cast<const float*>(vx);
  const auto* y = static_cast<const float*>(vy);
  const auto* z = static_cast<const float*>(vz);
  const auto* l = static_cast<const float*>(lim);
  const auto* ar = static_cast<const float*>(area);
  const auto* sp = static_cast<const float4*>(sphere);
  const auto* km = static_cast<const int32_t*>(tile_kmax);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define RUSTSASA_CASE(K) \
  case K:                \
    return launch<K>(x, y, z, l, ar, sp, km, o, n, kdim, p, passes, s);
    RUSTSASA_CASE(1) RUSTSASA_CASE(2) RUSTSASA_CASE(3) RUSTSASA_CASE(4)
    RUSTSASA_CASE(5) RUSTSASA_CASE(6) RUSTSASA_CASE(7) RUSTSASA_CASE(8)
    RUSTSASA_CASE(9) RUSTSASA_CASE(10) RUSTSASA_CASE(11) RUSTSASA_CASE(12)
    RUSTSASA_CASE(13) RUSTSASA_CASE(14) RUSTSASA_CASE(15) RUSTSASA_CASE(16)
#undef RUSTSASA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
