// Per-half-admission occlusion-count kernel for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel `_pair64_kernel` (scripts/r5_pair64.py,
// launched by `_counts_call_2h`).  It computes fused_count.cu's counts,
// but each j-list entry carries two group masks: mask A, admitted by the
// i-tile's atoms 0-63, in the entry (mask_a << 16) | j_tile of jlist_a,
// and mask B, admitted by atoms 64-127, in the low 16 bits of jmask_b.
// Each half streams only its own groups: ~14 % fewer margins than the
// union mask on the corpus (the TPU study's 911 -> 783 j-atoms per atom).
//
// Bound: FP32 ALU throughput, as fused_count.cu.  The TPU kernel could
// not turn the saving into time: a group admitted by one half had to
// share a [P, 128] block with a group of the other half through per-lane
// selects (its both / onlyA / onlyB mixed streams).  Here a warp is 32
// consecutive i-atoms of one point slice, so the half, and with it the
// mask a thread walks, is uniform over each warp: the two halves' warps
// simply run different group loops, with no selects and no divergence.
// A j-tile is staged when either mask is non-zero.  Counts equal
// fused_count's: a group not admitted for a half holds no j-atom within
// reach of that half's atoms.
//
// Warp placement.  The SM's four schedulers each take the warps w with
// the same w % 4, and every entry ends at the barrier before the next
// j-tile.  With fused_count's placement (atom tid % 128) warps w % 4 in
// {0, 1} are atoms 0-63 and {2, 3} atoms 64-127, so each entry would
// take as long as its larger half.  Here warp w holds atoms 32 * (w / 4)
// .. + 31 of slice w % 4: each scheduler runs two warps of each half,
// and an entry costs the halves' sum, the lane-weighted work.

#include "count_tile.cuh"

namespace {

using namespace rustsasa;

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
pair64_count_kernel(const float* __restrict__ planes,     // [8, m]
                    const int32_t* __restrict__ jlist_a,  // [m/128, 128]
                    const int32_t* __restrict__ jmask_b,  // [m/128, 128]
                    const float4* __restrict__ sphere,    // [p]
                    int32_t* __restrict__ out,            // [m]
                    int m, int p, int passes) {
  extern __shared__ float4 smem[];
  const int n_cover = passes * kSlices * K;
  float4* sph = smem;
  float* jrec = reinterpret_cast<float*>(smem + n_cover);
  int* cnt = reinterpret_cast<int*>(jrec + kRecords * kAtomTile);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int slice = warp % kSlices;
  const int a = (warp / kSlices) * 32 + tid % 32;
  const int tile = blockIdx.x;
  const int n_tiles = m / kAtomTile;
  const int64_t mm = m;
  const int64_t i = static_cast<int64_t>(tile) * kAtomTile + a;

  stage_sphere(sph, sphere, p, n_cover);
  if (tid < kAtomTile) cnt[tid] = 0;
  const IAtom at = load_i_atom(planes, mm, i);
  const bool half_b = a >= kHalf;  // uniform over the warp

  const int32_t* row_a = jlist_a + static_cast<int64_t>(tile) * kJlistRows;
  const int32_t* row_b = jmask_b + static_cast<int64_t>(tile) * kJlistRows;
  const int n_entries = min(max(row_a[0], 0), kJlistRows - 1);
  int accessible = 0;

  for (int pass = 0; pass < passes; ++pass) {
    __syncthreads();  // sphere and counters staged
    const int p0 = (pass * kSlices + slice) * K;
    float sx[K], sy[K], sz[K], occ[K];
    load_points<K>(sph, p0, kNegBig, sx, sy, sz, occ);
    for (int e = 0; e < n_entries; ++e) {
      const uint32_t entry = static_cast<uint32_t>(row_a[1 + e]);
      const int jt = static_cast<int>(entry & 0xFFFFu);
      const uint32_t mask_a = entry >> 16;
      const uint32_t mask_b = static_cast<uint32_t>(row_b[1 + e]) & 0xFFFFu;
      if (jt >= n_tiles || (mask_a | mask_b) == 0u) continue;  // CTA-uniform
      load_j_tile(jrec, planes, mm, jt);
      uint32_t mask = half_b ? mask_b : mask_a;
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
int launch(const float* planes, const int32_t* jlist_a,
           const int32_t* jmask_b, const float4* sphere, int32_t* out, int m,
           int p, int passes, cudaStream_t stream) {
  pair64_count_kernel<K>
      <<<m / kAtomTile, kThreads, count_smem(passes, K), stream>>>(
          planes, jlist_a, jmask_b, sphere, out, m, p, passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  planes: f32
// [8, m] (rows x, y, z, r_eff, gid+1); jlist_a, jmask_b: i32 [m/128, 128];
// sphere: f32 [p, 4]; out: i32 [m].  m is a positive multiple of 128 and
// 0 < p <= 2048.  Returns the cudaError_t of the launch (0 = success).
extern "C" int pair64_count_launch(const void* planes, const void* jlist_a,
                                   const void* jmask_b, const void* sphere,
                                   void* out, int m, int p, void* stream) {
  int passes, k;
  if (m <= 0 || m % kAtomTile != 0 || !count_split(p, &passes, &k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RUSTSASA_SWITCH_K(
      k, launch<K>(static_cast<const float*>(planes),
                   static_cast<const int32_t*>(jlist_a),
                   static_cast<const int32_t*>(jmask_b),
                   static_cast<const float4*>(sphere),
                   static_cast<int32_t*>(out), m, p, passes,
                   static_cast<cudaStream_t>(stream)))
}
