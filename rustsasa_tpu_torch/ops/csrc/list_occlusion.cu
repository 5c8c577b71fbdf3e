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
// Bound: FP32 issue.  Per (point, atom, k) triple the test needs 3 FMUL,
// 2 FADD and a compare; the design keeps everything else off the triple:
//   * the loops are rotated: a thread holds kRecs = 16 of its atom's
//     records in registers and reads the points from shared memory as
//     warp-uniform LDS.128 broadcasts, so one point's test over the 16
//     records folds into one predicate (a chain of FSETP.LT.OR) and sets
//     one bit: 6.36 instructions a triple in the loop's SASS (a tail of
//     at most 8 rows takes an 8-record chunk);
//   * one CTA covers a (tile, block of up to 128 points) work item: 256
//     threads = 128 atoms x 2 point halves of up to 64 points (two
//     occlusion words), a warp being 32 atoms of one half.  P <= 128
//     takes one block, so each record is read once per tile;
//   * the tile's records stream through shared memory 16 rows a stage,
//     double-buffered with 16-byte cp.async copies (n is a multiple of 4,
//     so every row starts 16-byte aligned; zero-filled past the tile's
//     bound or the last atom: v = 0, limit = 0 never occludes), one
//     barrier a stage; the loop stops at the tile's own bound, uniform
//     across the CTA;
//   * 68,096 B of shared memory and <= 128 registers hold 2 CTAs on an
//     SM: one wave for 1jz8's 256 tiles.  Tiles run in index order;
//   * a sphere of more than 128 points is split over CTAs: each adds its
//     integer count to counts[i] with atomicAdd (exact in any order) and
//     a finishing kernel multiplies by the area; with one block a CTA
//     writes area * count itself.  No cap on the number of points.
// scripts/layout_probe.py times the choices against their alternatives.
// The result equals the plain version bit for bit: every product and sum
// is an explicitly rounded __f*_rn intrinsic in the reference's order, and
// the library is built with --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAtomTile = 128;
constexpr int kHalves = 2;
constexpr int kThreads = kAtomTile * kHalves;
constexpr int kWords = 2;
constexpr int kBlockPoints = kHalves * kWords * 32;
constexpr int kRecs = 16;
constexpr int kPointUnroll = 4;
constexpr int kMinCtas = 2;
constexpr int kStageRows = 16;
constexpr int kPlanes = 4;
constexpr int kStageFloats = kPlanes * kStageRows * kAtomTile;
constexpr size_t kSmemBytes =
    sizeof(float) * 2 * kStageFloats + sizeof(float4) * kBlockPoints +
    sizeof(int) * kAtomTile;

// Rows [k0, k0 + 16) of the tile's four record planes into buf
// ([plane][row][atom]) as 16-byte cp.async copies of 4 atoms, 8 a thread,
// zero-filled past the tile's bound and the last atom (n is a multiple of
// 4); one commit group.
__device__ __forceinline__ void stage_rows(float* buf,
                                           const float* const (&planes)[4],
                                           int64_t nn, int64_t base, int k0,
                                           int kmax) {
  constexpr int kCols = kAtomTile / 4;        // copies a row
  constexpr int kRowStep = kThreads / kCols;  // rows a pass
  const int c = (threadIdx.x % kCols) * 4;
  const bool atom_ok = base + c < nn;
#pragma unroll
  for (int pl = 0; pl < kPlanes; ++pl) {
#pragma unroll
    for (int q = 0; q < kStageRows / kRowStep; ++q) {
      const int r = q * kRowStep + threadIdx.x / kCols;
      const bool ok = atom_ok && k0 + r < kmax;
      const float* src =
          ok ? planes[pl] + static_cast<int64_t>(k0 + r) * nn + base + c
             : planes[pl];
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
          buf + (pl * kStageRows + r) * kAtomTile + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst),
                   "l"(src), "r"(ok ? 16 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ORs into words[] the occlusion of the thread's points sph[0, np) by
// rows r0 .. r0 + R - 1 of the staged records buf (atom a), held in
// registers (bit q of words[w] is point 32 w + q).
template <int R>
__device__ __forceinline__ void occlude(uint32_t (&words)[kWords],
                                        const float* buf, int r0, int a,
                                        const float4* sph, int np) {
  float vx[R], vy[R], vz[R], lim[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    vx[r] = buf[(0 * kStageRows + r0 + r) * kAtomTile + a];
    vy[r] = buf[(1 * kStageRows + r0 + r) * kAtomTile + a];
    vz[r] = buf[(2 * kStageRows + r0 + r) * kAtomTile + a];
    lim[r] = buf[(3 * kStageRows + r0 + r) * kAtomTile + a];
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int q_end = min(32, np - 32 * w);
    uint32_t bits = 0u;
#pragma unroll kPointUnroll
    for (int q = 0; q < q_end; ++q) {
      const float4 s = sph[32 * w + q];
      bool o = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dot = __fadd_rn(
            __fadd_rn(__fmul_rn(s.x, vx[r]), __fmul_rn(s.y, vy[r])),
            __fmul_rn(s.z, vz[r]));
        o |= dot < lim[r];
      }
      bits |= static_cast<uint32_t>(o) << q;
    }
    words[w] |= bits;
  }
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
list_occlusion_kernel(const float* __restrict__ vx,       // [kdim, n]
                      const float* __restrict__ vy,       // [kdim, n]
                      const float* __restrict__ vz,       // [kdim, n]
                      const float* __restrict__ lim,      // [kdim, n]
                      const float* __restrict__ area,     // [n]
                      const float4* __restrict__ sphere,  // [p]
                      const int32_t* __restrict__ tile_kmax,  // [tiles]
                      int32_t* __restrict__ counts,       // [n] or null
                      float* __restrict__ out,            // [n]
                      int n, int kdim, int p, int blocks, int pb, int hp) {
  extern __shared__ float4 smem[];
  float* stages = reinterpret_cast<float*>(smem);        // [2][4][16][128]
  float4* sph = reinterpret_cast<float4*>(stages + 2 * kStageFloats);
  int* cnt = reinterpret_cast<int*>(sph + kBlockPoints);  // [128]

  const int tid = threadIdx.x;
  const int a = tid % kAtomTile;
  const int h = tid / kAtomTile;
  const int tile = blockIdx.x / blocks;
  const int b = blockIdx.x % blocks;
  const int64_t nn = n;
  const int64_t base = static_cast<int64_t>(tile) * kAtomTile;
  const int kmax = min(max(tile_kmax[tile], 0), kdim);
  const float* const planes[4] = {vx, vy, vz, lim};

  // This CTA's points [b0, b1), this half's [lo, hi).
  const int b0 = b * pb;
  const int b1 = min(p, b0 + pb);
  const int lo = min(b1, b0 + h * hp);
  const int np = min(b1, lo + hp) - lo;
  for (int q = tid; q < b1 - b0; q += kThreads) sph[q] = sphere[b0 + q];

  const int n_stages = (kmax + kStageRows - 1) / kStageRows;
  if (n_stages > 0) stage_rows(stages, planes, nn, base, 0, kmax);
  uint32_t words[kWords] = {0u, 0u};
  for (int st = 0; st < n_stages; ++st) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // Stage st is visible, and every thread is done with the buffer the
    // next stage overwrites.
    __syncthreads();
    if (st + 1 < n_stages) {
      stage_rows(stages + ((st + 1) & 1) * kStageFloats, planes, nn, base,
                 (st + 1) * kStageRows, kmax);
    }
    const float* buf = stages + (st & 1) * kStageFloats;
    const int rows = min(kStageRows, kmax - st * kStageRows);
    for (int r0 = 0; r0 < rows; r0 += kRecs) {
      // A tail of at most kRecs / 2 rows takes the half-size chunk.
      if (rows - r0 > kRecs / 2) {
        occlude<kRecs>(words, buf, r0, a, sph + (lo - b0), np);
      } else {
        occlude<kRecs / 2>(words, buf, r0, a, sph + (lo - b0), np);
      }
    }
  }
  if (n_stages == 0) __syncthreads();  // the sphere is staged

  int accessible = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int q_end = min(32, np - 32 * w);
    uint32_t valid = 0u;
    for (int q = 0; q < q_end; ++q) {
      if (sph[lo - b0 + 32 * w + q].w > 0.0f) valid |= 1u << q;
    }
    accessible += __popc(valid & ~words[w]);
  }
  if (h == 1) cnt[a] = accessible;
  __syncthreads();
  if (h == 0 && base + a < nn) {
    accessible += cnt[a];
    if (counts == nullptr) {
      out[base + a] =
          __fmul_rn(static_cast<float>(accessible), area[base + a]);
    } else {
      atomicAdd(&counts[base + a], accessible);
    }
  }
}

// out = area * counts, after every block of points has added its count.
__global__ void list_finish_kernel(const int32_t* __restrict__ counts,
                                   const float* __restrict__ area,
                                   float* __restrict__ out, int n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fmul_rn(static_cast<float>(counts[i]), area[i]);
}

}  // namespace

// Launches the kernel and, for blocks > 1, the finishing kernel on
// `stream` without synchronizing.  vx, vy, vz, lim: f32 [kdim, n] with n
// a multiple of 4; area: f32 [n]; sphere: f32 [p, 4]; tile_kmax: i32
// [ceil(n / 128)]; counts: i32 scratch [n] when blocks > 1 (else
// unused); out: f32 [n].  The sphere is covered by `blocks` blocks of pb
// points, each split into two halves of hp points (the wrapper's
// list_point_plan): blocks * pb >= p, pb <= 128, hp <= 64, 2 * hp >= pb.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int list_occlusion_launch(const void* vx, const void* vy,
                                     const void* vz, const void* lim,
                                     const void* area, const void* sphere,
                                     const void* tile_kmax, void* counts,
                                     void* out, int n, int kdim, int p,
                                     int blocks, int pb, int hp,
                                     void* stream) {
  const int tiles = (n + kAtomTile - 1) / kAtomTile;
  if (n <= 0 || n % 4 != 0 || kdim <= 0 || p <= 0 || blocks <= 0 ||
      static_cast<int64_t>(blocks) * pb < p || pb > kBlockPoints ||
      hp > kWords * 32 || kHalves * hp < pb ||
      static_cast<int64_t>(tiles) * blocks > 0x7fffffff ||
      (blocks > 1 && counts == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* cts = blocks > 1 ? static_cast<int32_t*>(counts) : nullptr;
  auto* o = static_cast<float*>(out);
  const auto* ar = static_cast<const float*>(area);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      list_occlusion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cts != nullptr) {
    e = cudaMemsetAsync(cts, 0, sizeof(int32_t) * n, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  list_occlusion_kernel<<<tiles * blocks, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(vz), static_cast<const float*>(lim), ar,
      static_cast<const float4*>(sphere),
      static_cast<const int32_t*>(tile_kmax), cts, o, n, kdim, p, blocks, pb,
      hp);
  e = cudaGetLastError();
  if (e != cudaSuccess || cts == nullptr) return static_cast<int>(e);
  list_finish_kernel<<<(n + 255) / 256, 256, 0, s>>>(cts, ar, o, n);
  return static_cast<int>(cudaGetLastError());
}
