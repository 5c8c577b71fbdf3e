// Loop micro-variants of the occlusion-count kernel for NVIDIA Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel built by `make_kernel(variant)`
// (scripts/r4_microkernel.py, launched by `run_variant_counts`).  It
// computes fused_count.cu's counts on the host-cull j-lists, entries
// (mask << 16) | j_tile, on kernel 1's reach-skip layout (reach_ring.cuh:
// 16 lanes an atom, a ballot over each admitted 32-row chunk's kept
// rows, j-tiles through the ring), with the loop over a chunk's kept
// rows reshaped:
//   prod    one kept row an iteration (kernel 1's loop);
//   split2  two running-max arrays taking the chunk's kept rows in turn,
//           merged after the pass: half the serial max chain;
//   g16     two kept rows an iteration, g24 three; an odd tail repeats
//           the last kept row (an idempotent max), as the script's
//           glist[min(k*2+1, pos-1)] repeats the last group;
//   nosmem  the control: no reach test, no ballot and no compaction of
//           the groups: every row of every entry on a tile of the chunk,
//           each limit offset by a gate of 0 (group bit set) or -1e30.
// Every variant takes the max of the margins the reference does, leaving
// out only rows whose rounded margins are all <= 0 (keep_row,
// count_tile.cuh: padding atoms keep their rows, so the counts are the
// reference's at every slot), or adding margins at or below -1e30
// (nosmem): all give the reference's counts.
//
// Bound: FP32 issue (7 instructions a margin), on the work the inputs
// need for the four reach-skip variants (chip_smoke.recount_bound), on
// its own work for nosmem (every row of every live entry).  The TPU
// study asked which loop shape amortizes the per-group setup on the VPU;
// here a kept row's setup (v, lim: 13 instructions) is shared by a
// lane's K points, and the question is what the scheduler makes of two
// or three independent rows an iteration (g16, g24) or of a second
// accumulator (split2: 2K live registers, so one CTA an SM at K = 7).

#include "reach_ring.cuh"

namespace {

using namespace rustsasa;

enum Variant { kProd = 0, kSplit2, kG16, kG24, kNoSmem, kVariants };

constexpr int kSphereOffset = kRingSmemEnd;

// The register budget's points: split2 keeps a second K of maxima.
constexpr int budget_points(int k, int v) {
  return v == kSplit2 ? k + (k + 3) / 4 : k;
}

// Streams the rows of chunk c set in the ballot u, in the loop shape of
// variant V (one of prod, split2, g16, g24).
template <int K, int V>
__device__ __forceinline__ void stream_variant(
    uint32_t u, uint32_t keep, const float* jrec, int c, int a_local,
    const IAtom& at, const float (&sx)[K], const float (&sy)[K],
    const float (&sz)[K], float (&occ)[K], float (&occ2)[K]) {
  if constexpr (V == kProd) {
    stream_rows<K>(u, keep, jrec, ChunkRows{c}, a_local, at, sx, sy, sz, occ);
  } else {
    while (u != 0u) {  // uniform over the warp
      const int b1 = __ffs(u) - 1;
      u &= u - 1u;
      float vx1, vy1, vz1;
      const float lim1 =
          rows_lim(jrec, ChunkRows{c}, b1, keep, a_local, at, vx1, vy1, vz1);
      if constexpr (V == kSplit2) {
        row_margins<K>(vx1, vy1, vz1, lim1, sx, sy, sz, occ);
        if (u == 0u) break;
        const int b2 = __ffs(u) - 1;
        u &= u - 1u;
        float vx2, vy2, vz2;
        const float lim2 =
            rows_lim(jrec, ChunkRows{c}, b2, keep, a_local, at, vx2, vy2, vz2);
        row_margins<K>(vx2, vy2, vz2, lim2, sx, sy, sz, occ2);
      } else {
        int b2 = b1;
        if (u != 0u) {
          b2 = __ffs(u) - 1;
          u &= u - 1u;
        }
        float vx2, vy2, vz2;
        const float lim2 =
            rows_lim(jrec, ChunkRows{c}, b2, keep, a_local, at, vx2, vy2, vz2);
        row_margins<K>(vx1, vy1, vz1, lim1, sx, sy, sz, occ);
        row_margins<K>(vx2, vy2, vz2, lim2, sx, sy, sz, occ);
        if constexpr (V == kG24) {
          int b3 = b2;
          if (u != 0u) {
            b3 = __ffs(u) - 1;
            u &= u - 1u;
          }
          float vx3, vy3, vz3;
          const float lim3 = rows_lim(jrec, ChunkRows{c}, b3, keep, a_local,
                                      at, vx3, vy3, vz3);
          row_margins<K>(vx3, vy3, vz3, lim3, sx, sy, sz, occ);
        }
      }
    }
  }
}

template <int K, int V>
__global__ void __launch_bounds__(32 * kLanes, min_ctas(budget_points(K, V)))
micro_count_kernel(const float* __restrict__ planes,   // [8, m]
                   const int32_t* __restrict__ jlist,  // [m/128, 128]
                   const float4* __restrict__ sphere,  // [p]
                   int32_t* __restrict__ out,          // [m]
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
  const int n_tiles = m / kAtomTile;
  const int64_t mm = m;
  const int64_t atom0 = static_cast<int64_t>(tile) * kAtomTile +
                        (blockIdx.x % kQuarters) * kCtaAtoms;
  const int n_cover = passes * L * K;

  // Staging as kernel 1's; nosmem streams entries without a group bit too.
  if (warp == 0) {
    const int32_t* row = jlist + static_cast<int64_t>(tile) * kJlistRows;
    stage_entries<V == kNoSmem, false>(sm, nullptr, row,
                                       min(max(row[0], 0), kJlistRows - 1),
                                       n_tiles, lane);
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
    float sx[K], sy[K], sz[K], occ[K], occ2[K];
    load_points<K>(sph, p0, kNegBig, sx, sy, sz, occ);
#pragma unroll
    for (int k = 0; k < K; ++k) occ2[k] = occ[k];
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
      if constexpr (V == kNoSmem) {
#pragma unroll 1
        for (int gr = 0; gr < kAtomTile / kJGroup; ++gr) {
          const float gate = ((mask >> gr) & 1u) ? 0.0f : kNegBig;
#pragma unroll
          for (int r = 0; r < kJGroup; ++r) {
            float vx, vy, vz;
            const float lim = __fadd_rn(
                row_lim(jrec, gr * kJGroup + r, at, vx, vy, vz), gate);
            row_margins<K>(vx, vy, vz, lim, sx, sy, sz, occ);
          }
        }
      } else {
#pragma unroll 1
        for (int c = 0; c < kAtomTile / 32; ++c) {
          const uint32_t gm = (mask >> (4 * c)) & 0xFu;
          if (gm == 0u) continue;  // uniform over the warp
          const uint32_t keep =
              chunk_keep<true>(jrec, c, gm, sm, warp, lane, far_ok);
          const uint32_t u = __ballot_sync(kFullWarp, keep != 0u);
          stream_variant<K, V>(u, keep, jrec, c, a_local, at, sx, sy, sz, occ,
                               occ2);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&sm.empty[s]);
    }
    if (V == kSplit2) {
#pragma unroll
      for (int k = 0; k < K; ++k) occ[k] = fmaxf(occ[k], occ2[k]);
    }
    accessible += count_accessible<K>(sph, p0, occ);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    accessible += __shfl_xor_sync(kFullWarp, accessible, off);
  }
  if (q == 0) out[atom0 + cta_atom] = accessible;
}

template <int K, int V>
int launch_variant(const float* planes, const int32_t* jlist,
                   const float4* sphere, int32_t* out, int m, int p,
                   int passes, cudaStream_t stream) {
  const int smem = kSphereOffset + 16 * passes * kLanes * K;
  auto kernel = micro_count_kernel<K, V>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  }
  kernel<<<(m / kAtomTile) * kQuarters, 32 * kLanes, smem, stream>>>(
      planes, jlist, sphere, out, m, p, passes);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const float* planes, const int32_t* jlist, const float4* sphere,
           int32_t* out, int m, int p, int passes, int variant,
           cudaStream_t stream) {
  switch (variant) {
    case kProd:
      return launch_variant<K, kProd>(planes, jlist, sphere, out, m, p,
                                      passes, stream);
    case kSplit2:
      return launch_variant<K, kSplit2>(planes, jlist, sphere, out, m, p,
                                        passes, stream);
    case kG16:
      return launch_variant<K, kG16>(planes, jlist, sphere, out, m, p,
                                     passes, stream);
    case kG24:
      return launch_variant<K, kG24>(planes, jlist, sphere, out, m, p,
                                     passes, stream);
    default:
      return launch_variant<K, kNoSmem>(planes, jlist, sphere, out, m, p,
                                        passes, stream);
  }
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  planes: f32
// [8, m] (rows x, y, z, r_eff, gid+1), 16-byte aligned; jlist: i32
// [m/128, 128]; sphere: f32 [p, 4]; out: i32 [m].  m is a positive
// multiple of 128, 0 < p <= 2048 and variant is 0-4 (prod, split2, g16,
// g24, nosmem).  Returns the cudaError_t of the launch (0 = success).
extern "C" int micro_count_launch(const void* planes, const void* jlist,
                                  const void* sphere, void* out, int m,
                                  int p, int variant, void* stream) {
  if (m <= 0 || m % kAtomTile != 0 || p <= 0 || p > kMaxPPad ||
      variant < 0 || variant >= kVariants ||
      reinterpret_cast<uintptr_t>(planes) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int passes = (p + kLanes * kMaxK - 1) / (kLanes * kMaxK);
  const int k = (p + kLanes * passes - 1) / (kLanes * passes);
  RUSTSASA_SWITCH_K(
      k, launch<K>(static_cast<const float*>(planes),
                   static_cast<const int32_t*>(jlist),
                   static_cast<const float4*>(sphere),
                   static_cast<int32_t*>(out), m, p, passes, variant,
                   static_cast<cudaStream_t>(stream)))
}
