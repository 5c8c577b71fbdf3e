// Tile-saturation occlusion-count kernel for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel built by `make_kernel`
// (scripts/r4_saturation.py, variants tilesat_vmem / sat2 / sat4,
// launched by `run_variant_counts`).  It computes fused_count.cu's
// counts, and stops streaming a tile's j-list once every sphere point
// of every one of its 128 atoms is occluded: the remaining entries can
// only re-occlude occluded points, so the counts do not change.
//
// The rule, per point pass (pass q holds points [q*4*K, (q+1)*4*K)):
//   * a valid point's running max margin starts at -1e30, a pad point's
//     (valid = 0, or past the sphere's end) at +1, so pad points never
//     hold the check back;
//   * after entry e, when e % check_every == check_every - 1, the CTA is
//     done with the pass if min(occ) > 0 over all 128 atoms and all the
//     pass's points, and streams no further entry of it;
//   * streamed[tile] sums the entries each pass went through.
//
// Bound: FP32 ALU throughput, as fused_count.cu.  On the TPU the skip
// lost 1-5 % to pl.when round trips of the accumulator through VMEM.
// Here the check is one __syncthreads_and per checked entry, beside the
// two barriers that every staged j-tile already pays, and each thread
// tests its own K registers.

#include "count_tile.cuh"

namespace {

using namespace rustsasa;

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
saturation_count_kernel(const float* __restrict__ planes,   // [8, m]
                        const int32_t* __restrict__ jlist,  // [m/128, 128]
                        const float4* __restrict__ sphere,  // [p]
                        int32_t* __restrict__ out,          // [m]
                        int32_t* __restrict__ streamed,     // [m/128]
                        int m, int p, int passes, int check_every) {
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

  const int32_t* row = jlist + static_cast<int64_t>(tile) * kJlistRows;
  const int n_entries = min(max(row[0], 0), kJlistRows - 1);
  int accessible = 0;
  int n_streamed = 0;

  for (int pass = 0; pass < passes; ++pass) {
    __syncthreads();  // sphere and counters staged
    const int p0 = (pass * kSlices + slice) * K;
    float sx[K], sy[K], sz[K], occ[K];
    load_points<K>(sph, p0, 1.0f, sx, sy, sz, occ);
    int stop = n_entries;
    for (int e = 0; e < n_entries; ++e) {
      const uint32_t entry = static_cast<uint32_t>(row[1 + e]);
      const int jt = static_cast<int>(entry & 0xFFFFu);
      uint32_t mask = entry >> 16;
      if (jt < n_tiles && mask != 0u) {  // uniform over the CTA
        load_j_tile(jrec, planes, mm, jt);
        while (mask != 0u) {
          const int g = __ffs(mask) - 1;
          mask &= mask - 1u;
          stream_group<K>(jrec, g, at, sx, sy, sz, occ);
        }
      }
      if (e % check_every == check_every - 1) {
        int saturated = 1;
#pragma unroll
        for (int k = 0; k < K; ++k) saturated &= occ[k] > 0.0f ? 1 : 0;
        if (__syncthreads_and(saturated)) {  // the same answer in every thread
          stop = e + 1;
          break;
        }
      }
    }
    n_streamed += stop;
    accessible += count_accessible<K>(sph, p0, occ);
  }
  write_count(cnt, a, slice, accessible, out, i);
  if (tid == 0) streamed[tile] = n_streamed;
}

template <int K>
int launch(const float* planes, const int32_t* jlist, const float4* sphere,
           int32_t* out, int32_t* streamed, int m, int p, int passes,
           int check_every, cudaStream_t stream) {
  saturation_count_kernel<K>
      <<<m / kAtomTile, kThreads, count_smem(passes, K), stream>>>(
          planes, jlist, sphere, out, streamed, m, p, passes, check_every);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  planes: f32
// [8, m] (rows x, y, z, r_eff, gid+1); jlist: i32 [m/128, 128]; sphere:
// f32 [p, 4]; out: i32 [m]; streamed: i32 [m/128].  m is a positive
// multiple of 128, 0 < p <= 2048 and check_every >= 1.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int saturation_count_launch(const void* planes, const void* jlist,
                                       const void* sphere, void* out,
                                       void* streamed, int m, int p,
                                       int check_every, void* stream) {
  int passes, k;
  if (m <= 0 || m % kAtomTile != 0 || check_every < 1 ||
      !count_split(p, &passes, &k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RUSTSASA_SWITCH_K(
      k, launch<K>(static_cast<const float*>(planes),
                   static_cast<const int32_t*>(jlist),
                   static_cast<const float4*>(sphere),
                   static_cast<int32_t*>(out), static_cast<int32_t*>(streamed),
                   m, p, passes, check_every,
                   static_cast<cudaStream_t>(stream)))
}
