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
// matrix product, and the loads are not on the critical path.  The
// pieces it shares with its variants are in count_tile.cuh.

#include "count_tile.cuh"

namespace {

using namespace rustsasa;

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

  stage_sphere(sph, sphere, p, n_cover);
  if (tid < kAtomTile) cnt[tid] = 0;
  const IAtom at = load_i_atom(planes, mm, i);

  const int32_t* row = jlist + static_cast<int64_t>(tile) * kJlistRows;
  const int n_entries = min(max(row[0], 0), kJlistRows - 1);
  int accessible = 0;

  for (int pass = 0; pass < passes; ++pass) {
    __syncthreads();  // sphere and counters staged
    const int p0 = (pass * kSlices + slice) * K;
    float sx[K], sy[K], sz[K], occ[K];
    load_points<K>(sph, p0, kNegBig, sx, sy, sz, occ);
    for (int e = 0; e < n_entries; ++e) {
      const uint32_t entry = static_cast<uint32_t>(row[1 + e]);
      const int jt = static_cast<int>(entry & 0xFFFFu);
      uint32_t mask = entry >> 16;
      if (jt >= n_tiles || mask == 0u) continue;  // uniform over the CTA
      load_j_tile(jrec, planes, mm, jt);
      while (mask != 0u) {
        const int g = __ffs(mask) - 1;
        mask &= mask - 1u;
        stream_group<K>(jrec, g, at, sx, sy, sz, occ);
      }
    }
    accessible += count_accessible<K>(sph, p0, occ);
  }
  write_count(cnt, a, slice, accessible, out, i);
}

template <int K>
int launch(const float* planes, const int32_t* jlist, const float4* sphere,
           int32_t* out, int m, int p, int passes, cudaStream_t stream) {
  fused_count_kernel<K>
      <<<m / kAtomTile, kThreads, count_smem(passes, K), stream>>>(
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
  int passes, k;
  if (m <= 0 || m % kAtomTile != 0 || !count_split(p, &passes, &k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RUSTSASA_SWITCH_K(
      k, launch<K>(static_cast<const float*>(planes),
                   static_cast<const int32_t*>(jlist),
                   static_cast<const float4*>(sphere),
                   static_cast<int32_t*>(out), m, p, passes,
                   static_cast<cudaStream_t>(stream)))
}
