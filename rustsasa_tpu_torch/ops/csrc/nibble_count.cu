// Nibble-list occlusion-count kernel for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `_nibble_kernel` (scripts/r5_pair64.py,
// launched by `_counts_call_nibble`).  It computes fused_count.cu's
// counts, but the builder hands over each entry's admitted groups
// pre-compacted: the entry is (gcount << 16) | j_tile and the group ids
// are the first gcount 4-bit nibbles of w1 (ids 0-7 of the list) and w2
// (ids 8-15) in the same cells.  The kernel reads group k of the list as
// nibble k instead of finding the next set mask bit with __ffs.
//
// Bound: FP32 ALU throughput, as fused_count.cu; the streamed margins are
// the same, so only the per-group index work differs (a shift and a mask
// against __ffs and a clear), and that is a few integer instructions per
// 8 x K margin updates.  On the TPU the nibble lists removed a 16-step
// scalar compaction chain and measured a wash; the TPU kernel's clamped
// re-stream of the last group (its two-groups-per-iteration pairing) is
// not needed here.

#include "count_tile.cuh"

namespace {

using namespace rustsasa;

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
nibble_count_kernel(const float* __restrict__ planes,  // [8, m]
                    const int32_t* __restrict__ jl,    // [m/128, 128]
                    const int32_t* __restrict__ w1,    // [m/128, 128]
                    const int32_t* __restrict__ w2,    // [m/128, 128]
                    const float4* __restrict__ sphere,  // [p]
                    int32_t* __restrict__ out,          // [m]
                    int m, int p, int passes) {
  extern __shared__ float4 smem[];
  const int n_cover = passes * kSlices * K;
  float4* sph = smem;
  float* jrec = reinterpret_cast<float*>(smem + n_cover);
  int* cnt = reinterpret_cast<int*>(jrec + kRecords * kAtomTile);

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

  const int64_t row0 = static_cast<int64_t>(tile) * kJlistRows;
  const int n_entries = min(max(jl[row0], 0), kJlistRows - 1);
  int accessible = 0;

  for (int pass = 0; pass < passes; ++pass) {
    __syncthreads();  // sphere and counters staged
    const int p0 = (pass * kSlices + slice) * K;
    float sx[K], sy[K], sz[K], occ[K];
    load_points<K>(sph, p0, kNegBig, sx, sy, sz, occ);
    for (int e = 0; e < n_entries; ++e) {
      const uint32_t entry = static_cast<uint32_t>(jl[row0 + 1 + e]);
      const int jt = static_cast<int>(entry & 0xFFFFu);
      const int gcount = min(static_cast<int>(entry >> 16), 16);
      if (jt >= n_tiles || gcount == 0) continue;  // uniform over the CTA
      const uint32_t lo = static_cast<uint32_t>(w1[row0 + 1 + e]);
      const uint32_t hi = static_cast<uint32_t>(w2[row0 + 1 + e]);
      load_j_tile(jrec, planes, mm, jt);
      for (int n = 0; n < gcount; ++n) {
        const int g = static_cast<int>(((n < 8 ? lo : hi) >> (4 * (n & 7))) &
                                       0xFu);
        stream_group<K>(jrec, g, at, sx, sy, sz, occ);
      }
    }
    accessible += count_accessible<K>(sph, p0, occ);
  }
  write_count(cnt, a, slice, accessible, out, i);
}

template <int K>
int launch(const float* planes, const int32_t* jl, const int32_t* w1,
           const int32_t* w2, const float4* sphere, int32_t* out, int m,
           int p, int passes, cudaStream_t stream) {
  nibble_count_kernel<K>
      <<<m / kAtomTile, kThreads, count_smem(passes, K), stream>>>(
          planes, jl, w1, w2, sphere, out, m, p, passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  planes: f32
// [8, m] (rows x, y, z, r_eff, gid+1); jl, w1, w2: i32 [m/128, 128];
// sphere: f32 [p, 4]; out: i32 [m].  m is a positive multiple of 128 and
// 0 < p <= 2048.  Returns the cudaError_t of the launch (0 = success).
extern "C" int nibble_count_launch(const void* planes, const void* jl,
                                   const void* w1, const void* w2,
                                   const void* sphere, void* out, int m,
                                   int p, void* stream) {
  int passes, k;
  if (m <= 0 || m % kAtomTile != 0 || !count_split(p, &passes, &k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RUSTSASA_SWITCH_K(
      k, launch<K>(static_cast<const float*>(planes),
                   static_cast<const int32_t*>(jl),
                   static_cast<const int32_t*>(w1),
                   static_cast<const int32_t*>(w2),
                   static_cast<const float4*>(sphere),
                   static_cast<int32_t*>(out), m, p, passes,
                   static_cast<cudaStream_t>(stream)))
}
