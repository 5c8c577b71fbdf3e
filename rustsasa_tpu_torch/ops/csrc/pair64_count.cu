// Per-half-admission occlusion-count kernel for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel `_pair64_kernel` (scripts/r5_pair64.py,
// launched by `_counts_call_2h`).  It computes fused_count.cu's counts,
// but each j-list entry carries two group masks: mask A, admitted by the
// i-tile's atoms 0-63, in the entry (mask_a << 16) | j_tile of jlist_a,
// and mask B, admitted by atoms 64-127, in the low 16 bits of jmask_b.
// Each half streams only its own groups.
//
// Design: kernel 1's layout (reach_ring.cuh: 4 CTAs of 32 atoms a tile,
// 16 lanes an atom, lane_passes, the bulk-copy ring, no cluster), where a
// CTA's 32 atoms lie in one half: CTAs 0-1 of a tile hold atoms 0-63 and
// read mask A, CTAs 2-3 atoms 64-127 and mask B.  Warp 0 stages the
// tile's entries with the CTA's own mask in kernel 1's entry form, (mask
// << 16) | j_tile; an entry is live when that mask is non-zero and its
// j-tile is in the chunk.  So a CTA loads only the j-tiles its half
// admits and tests only the 32-row chunks holding its half's groups; the
// rest is kernel 1's loop: per admitted chunk a ballot over the rows one
// of the warp's two atoms keeps (keep_row, count_tile.cuh: padding atoms
// keep their rows, so the counts are the plain version's at every slot),
// and the warp streams those.  A group not admitted for a half holds no
// j-atom within reach of that half's atoms, so the counts are also
// fused_count's on the union mask.
//
// Bound: FP32 issue, as fused_count.cu, on the work the inputs need
// (chip_smoke.recount_bound).  The margins streamed are the rows kernel
// 1's per-warp skip keeps; what per-half staging saves is the j-tile loads
// and chunk tests of the other half's groups.

#include "reach_ring.cuh"

namespace {

using namespace rustsasa;

// csrc/reach_ring.cuh's layout; the sphere follows the ring's buffers.
constexpr int kSphereOffset = kRingSmemEnd;

template <int K>
__global__ void __launch_bounds__(32 * kLanes, min_ctas(K))
pair64_count_kernel(const float* __restrict__ planes,     // [8, m]
                    const int32_t* __restrict__ jlist_a,  // [m/128, 128]
                    const int32_t* __restrict__ jmask_b,  // [m/128, 128]
                    const float4* __restrict__ sphere,    // [p]
                    int32_t* __restrict__ out,            // [m]
                    int m, int p, int passes) {
  constexpr int L = kLanes;
  extern __shared__ __align__(128) unsigned char smem[];
  const RingSmem sm = ring_smem(smem);
  float4* sph = reinterpret_cast<float4*>(smem + kSphereOffset);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int a_local = lane / L;
  const int q = lane % L;
  const int tile = blockIdx.x / kQuarters;
  const int quarter = blockIdx.x % kQuarters;
  const int n_tiles = m / kAtomTile;
  const int64_t mm = m;
  const int64_t atom0 =
      static_cast<int64_t>(tile) * kAtomTile + quarter * kCtaAtoms;
  const int n_cover = passes * L * K;

  // Staging: the live entries of this CTA's half (uniform over the CTA).
  if (warp == 0) {
    const int64_t row0 = static_cast<int64_t>(tile) * kJlistRows;
    const int n_entries = min(max(jlist_a[row0], 0), kJlistRows - 1);
    if (quarter * kCtaAtoms < kHalf) {
      stage_entries<false, false>(sm, nullptr, jlist_a + row0, n_entries,
                                  n_tiles, lane);
    } else {
      stage_entries<false, false, true>(sm, nullptr, jlist_a + row0,
                                        n_entries, n_tiles, lane,
                                        jmask_b + row0);
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
    load_points<K>(sph, p0, kNegBig, sx, sy, sz, occ);
    for (int e = 0; e < n_live; ++e, ++g) {
      const int s = g % kRing;
      if (tid == 0) {
        next = produce<false>(g, next, total, sm, n_live, planes, mm,
                              nullptr);
      }
      __syncwarp();
      bar_wait(&sm.full[s], (g / kRing) & 1);
      const float* jrec = sm.slots + s * kTileFloats;
      const uint32_t mask = sm.ents[e] >> 16;
#pragma unroll 1
      for (int c = 0; c < kAtomTile / 32; ++c) {
        const uint32_t gm = (mask >> (4 * c)) & 0xFu;
        if (gm == 0u) continue;  // uniform over the warp
        const uint32_t keep =
            chunk_keep<true>(jrec, c, gm, sm, warp, lane, far_ok);
        const uint32_t u = __ballot_sync(kFullWarp, keep != 0u);
        stream_rows<K>(u, keep, jrec, ChunkRows{c}, a_local, at, sx, sy, sz,
                       occ);
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

template <int K>
int launch(const float* planes, const int32_t* jlist_a,
           const int32_t* jmask_b, const float4* sphere, int32_t* out, int m,
           int p, int passes, cudaStream_t stream) {
  const int smem = kSphereOffset + 16 * passes * kLanes * K;
  auto kernel = pair64_count_kernel<K>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  }
  kernel<<<(m / kAtomTile) * kQuarters, 32 * kLanes, smem, stream>>>(
      planes, jlist_a, jmask_b, sphere, out, m, p, passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  planes: f32
// [8, m] (rows x, y, z, r_eff, gid+1), 16-byte aligned; jlist_a, jmask_b:
// i32 [m/128, 128]; sphere: f32 [p, 4]; out: i32 [m].  m is a positive
// multiple of 128 and 0 < p <= 2048.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int pair64_count_launch(const void* planes, const void* jlist_a,
                                   const void* jmask_b, const void* sphere,
                                   void* out, int m, int p, void* stream) {
  if (m <= 0 || m % kAtomTile != 0 || p <= 0 || p > kMaxPPad ||
      reinterpret_cast<uintptr_t>(planes) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int passes = (p + kLanes * kMaxK - 1) / (kLanes * kMaxK);
  const int k = (p + kLanes * passes - 1) / (kLanes * passes);
  RUSTSASA_SWITCH_K(
      k, launch<K>(static_cast<const float*>(planes),
                   static_cast<const int32_t*>(jlist_a),
                   static_cast<const int32_t*>(jmask_b),
                   static_cast<const float4*>(sphere),
                   static_cast<int32_t*>(out), m, p, passes,
                   static_cast<cudaStream_t>(stream)))
}
