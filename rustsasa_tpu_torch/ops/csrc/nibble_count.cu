// Nibble-list occlusion-count kernel for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `_nibble_kernel` (scripts/r5_pair64.py:472,
// launched by `_counts_call_nibble`).  It computes fused_count.cu's
// counts, but the builder hands over each entry's admitted groups
// compacted: the entry is (gcount << 16) | j_tile and the group ids are
// the first gcount 4-bit nibbles of w1 (list positions 0-7) and w2 (8-15)
// in the same cells; gcount is read up to 16.
//
// Design: kernel 1's layout (reach_ring.cuh: 4 CTAs of 32 atoms a tile,
// 16 lanes an atom, lane_passes, the bulk-copy ring; an entry is live
// when gcount != 0 and its j-tile is in the chunk).  Where kernel 1 runs
// each of a j-tile's four 32-row chunks that holds an admitted group, this
// kernel packs the entry's admitted groups four at a time into the reach
// test's chunks: lane l of packed chunk q tests row 8 g[4q + l/8] + l % 8
// (OctetRows), g[n] the list's nibble n, so an entry runs ceil(gcount / 4)
// chunks.  Per chunk a ballot gives the rows one of the warp's two atoms
// keeps (keep_row, count_tile.cuh: padding atoms keep their rows, so the
// counts are the plain version's at every slot), and the warp streams
// those.  A max does not depend on order and a repeated group id repeats
// an idempotent max, so the counts are those of the decoded group mask.
//
// Bound: FP32 issue, as fused_count.cu, on the work the inputs need
// (chip_smoke.recount_bound); the packing cuts the reach tests, not the
// streamed margins.

#include "reach_ring.cuh"

namespace {

using namespace rustsasa;

// Shared memory after the ring's: the live entries' j-list positions,
// their (w1, w2) words, the sphere.
constexpr int kPosOffset = kRingSmemEnd;
constexpr int kListsOffset = kPosOffset + kJlistRows;
constexpr int kSphereOffset = kListsOffset + 8 * kJlistRows;
static_assert(kListsOffset % 8 == 0 && kSphereOffset % 16 == 0,
              "uint2 and float4 arrays need alignment");

template <int K>
__global__ void __launch_bounds__(32 * kLanes, min_ctas(K))
nibble_count_kernel(const float* __restrict__ planes,   // [8, m]
                    const int32_t* __restrict__ jl,     // [m/128, 128]
                    const int32_t* __restrict__ w1,     // [m/128, 128]
                    const int32_t* __restrict__ w2,     // [m/128, 128]
                    const float4* __restrict__ sphere,  // [p]
                    int32_t* __restrict__ out,          // [m]
                    int m, int p, int passes) {
  constexpr int L = kLanes;
  extern __shared__ __align__(128) unsigned char smem[];
  const RingSmem sm = ring_smem(smem);
  uint8_t* pos = smem + kPosOffset;
  uint2* lists = reinterpret_cast<uint2*>(smem + kListsOffset);
  float4* sph = reinterpret_cast<float4*>(smem + kSphereOffset);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int a_local = lane / L;
  const int q = lane % L;
  const int tile = blockIdx.x / kQuarters;
  const int n_tiles = m / kAtomTile;
  const int64_t mm = m;
  const int64_t atom0 = static_cast<int64_t>(tile) * kAtomTile +
                        (blockIdx.x % kQuarters) * kCtaAtoms;
  const int n_cover = passes * L * K;

  // Staging: the live entries (gcount != 0) in order, and their words.
  if (warp == 0) {
    const int64_t row0 = static_cast<int64_t>(tile) * kJlistRows;
    stage_entries<false, true>(sm, pos, jl + row0,
                               min(max(jl[row0], 0), kJlistRows - 1),
                               n_tiles, lane);
    __syncwarp();
    const int n = *sm.n_live;
    for (int i = lane; i < n; i += 32) {
      const int64_t cell = row0 + 1 + pos[i];
      lists[i] = make_uint2(static_cast<uint32_t>(w1[cell]),
                            static_cast<uint32_t>(w2[cell]));
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
      const int gcount = min(static_cast<int>(sm.ents[e] >> 16), 16);
      const uint2 words = lists[e];
#pragma unroll 1
      for (int c = 0; 4 * c < gcount; ++c) {  // uniform over the warp
        const OctetRows rows{((c < 2 ? words.x : words.y) >> (16 * (c & 1))) &
                             0xFFFFu};
        const uint32_t keep = rows_keep<kKeepRow>(
            jrec, rows, 4 * c + (lane >> 3) < gcount, sm, warp, lane,
            far_ok);
        const uint32_t u = __ballot_sync(kFullWarp, keep != 0u);
        stream_rows<K>(u, keep, jrec, rows, a_local, at, sx, sy, sz, occ);
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
int launch(const float* planes, const int32_t* jl, const int32_t* w1,
           const int32_t* w2, const float4* sphere, int32_t* out, int m,
           int p, int passes, cudaStream_t stream) {
  const int smem = kSphereOffset + 16 * passes * kLanes * K;
  auto kernel = nibble_count_kernel<K>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  }
  kernel<<<(m / kAtomTile) * kQuarters, 32 * kLanes, smem, stream>>>(
      planes, jl, w1, w2, sphere, out, m, p, passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  planes: f32
// [8, m] (rows x, y, z, r_eff, gid+1), 16-byte aligned; jl, w1, w2: i32
// [m/128, 128]; sphere: f32 [p, 4]; out: i32 [m].  m is a positive
// multiple of 128 and 0 < p <= 2048.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int nibble_count_launch(const void* planes, const void* jl,
                                   const void* w1, const void* w2,
                                   const void* sphere, void* out, int m,
                                   int p, void* stream) {
  if (m <= 0 || m % kAtomTile != 0 || p <= 0 || p > kMaxPPad ||
      reinterpret_cast<uintptr_t>(planes) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int passes = (p + kLanes * kMaxK - 1) / (kLanes * kMaxK);
  const int k = (p + kLanes * passes - 1) / (kLanes * passes);
  RUSTSASA_SWITCH_K(
      k, launch<K>(static_cast<const float*>(planes),
                   static_cast<const int32_t*>(jl),
                   static_cast<const int32_t*>(w1),
                   static_cast<const int32_t*>(w2),
                   static_cast<const float4*>(sphere),
                   static_cast<int32_t*>(out), m, p, passes,
                   static_cast<cudaStream_t>(stream)))
}
