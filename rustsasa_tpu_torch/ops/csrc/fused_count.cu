// Occlusion-count kernel for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_fused_count_kernel`
// (rustsasa_tpu/ops/fused_kernel.py:131, launched by `_counts_call`).  For
// every i-atom of a 128-atom tile and every sphere point it takes the max
// over the admitted j-atoms of the occlusion margin
//     lim - dot,  v = c_i - c_j,  v2 = (vx*vx + vy*vy) + vz*vz,
//     lim = ((r_j*r_j - v2) - r_i*r_i) * (0.5 / max(r_i, 1e-6)),
//     dot = sx*vx + (sy*vy + sz*vz),
// with lim = -1e30 where gid_j == gid_i or gid_j == 0 (padding), and
// counts the valid points whose max is <= 0.  Admitted j-atoms are the
// 8-atom groups whose bit is set in a j-list entry (mask << 16) | j_tile.
//
// Counts equal the reference bit for bit: every margin is computed as the
// reference computes it (row_v, row_lim_kept and row_margins of
// count_tile.cuh: explicitly rounded __f*_rn intrinsics in the
// reference's order, and the library is built with --fmad=false).  A max
// does not depend on order, so streaming a subset of the admitted rows,
// in any order, gives the same counts as long as every row left out has
// all its rounded margins <= 0.  The design streams only such a subset.
//
// Bound: FP32 issue (33.5T instructions/s on the H100 SXM) on the work
// the inputs need: 7 instructions (3 mul, 2 add, 1 sub, 1 max) per point
// for each (i, j) pair in reach, v2 < (r_i + r_j)^2 with distinct, non-zero
// gids, plus the reach test's arithmetic for each admitted pair (14: v2,
// (r_i + r_j)^2, the slack, the compare and two gid compares;
// fused_kernel.REACH_INSTR_PER_PAIR); chip_smoke.py counts both from the
// chunk.  The margin's roundings (3 mul and 2 add, each
// rounded) are the reference's and cannot come out of mma or wgmma, whose
// products and sums round otherwise: no tensor cores.  On the H100 the
// kernel reaches ~0.28 of that bound (PERF.md).  On the corpus's banded
// chunks an atom has ~820-920 admitted j-atoms but ~43 in reach, so the
// design spends its instructions on finding the 43:
//   * an i-atom has L = kLanes = 16 lanes, each holding K = ceil(P / L)
//     sphere points and their running maxima in registers (more points
//     than L x kMaxK take passes, each re-streaming the j-list); a warp is
//     32 / L = 2 consecutive atoms, a CTA 32 atoms (a quarter i-tile, L
//     warps).  At P = 100, 16 lanes of 7 points ran 3-4 % faster than 8
//     lanes of 13 on the H100 (PERF.md), so L is fixed at 16;
//   * for each admitted 32-row chunk of a j-tile, lane l tests row l
//     against the warp's atoms (keep_pair), a ballot gives the rows some
//     atom keeps, and the warp streams only those, uniformly (no
//     divergence): each row's v and lim for the lane's own atom (lim =
//     -1e30 where the atom itself does not keep it) and its K margins;
//   * the tile's live j-list entries are compacted once; their j-tiles
//     (5 x 512 B) arrive through a ring of kRing slots in shared memory,
//     each filled by five cp.async.bulk copies completing on the slot's
//     "full" mbarrier, so the next entries are in flight while one is
//     consumed; each warp arrives on the slot's "empty" mbarrier when done
//     with it, and lane 0 of warp 0 refills a slot once every warp has
//     (there is no CTA barrier in the loop, so warps run at their own
//     pace, up to kRing entries apart);
//   * an atom's count is the sum of its lanes' (shuffles), so nothing but
//     the out-of-loop staging needs a barrier.
//
// The skip (keep_pair) is conservative by construction.  A row is left
// out only where its lim is -1e30 anyway (gid_j == gid_i, gid_j == 0; or
// the i-atom is padding, gid 0: the count at a padding slot is not the
// reference's, and no caller reads it), or where
//     v2 > (r_i + r_j)^2 * (1 + delta),  delta = 2^-14,
// r_i >= 1e-6, r_j >= r_i / 8 and every valid sphere point has
// |s|^2 <= 1 + 2^-20 as computed (so |s| <= sigma = 1 + 9.51u,
// u = 2^-24).  Derivation: let V be the rounded v (the margins and the
// test round it alike), D = |V|, R = r_i + r_j, D = R + g.  The rounded
// v2 is within 3.01u D^2 of D^2 and the test's threshold at least
// R^2 (1 + delta)(1 - u)^4, so a skip means g >= gamma R, gamma =
// delta / 2 - 3.5u - delta^2 / 8 = 3.031e-5.  A rounded margin is > 0
// only if lim' > dot' (the last subtraction keeps the sign), and
//     lim' <= b / (2 r_i) + u (2 r_j^2 + 7.02 D^2 + 4.01 r_i^2) / (2 r_i),
//     dot' >= s.V - 3.01u sigma D,   b = r_j^2 - r_i^2 - D^2,
// (error of each rounded step), while b / (2 r_i) + sigma D =
// -g (r_j / r_i + 1 - sigma) - g^2 / (2 r_i) + (sigma - 1) R: past
// tangency the margin falls at slope r_j / r_i.  So the margin stays <= 0
// if
//     g (r_j + r_i (1 - sigma)) + g^2 / 2 > (sigma - 1) R r_i
//         + u (2 r_j^2 + 7.02 D^2 + 4.01 r_i^2) / 2 + 3.01u sigma D r_i,
// whose left side grows faster in g than the right.  At g = gamma R and
// the worst ratio r_j = r_i / 8 the left side is 3.5x the right (at
// r_j = r_i, 24x).  An exact test (delta = 0) is not enough: a rounded
// margin can be +4.8e-7 at pairs it calls out of reach
// (tests/test_torch_count_reach.py builds such pairs).
//
// fused_count_rows_launch, for chip_smoke.py only, also counts the rows
// each warp streamed (the kRows instantiation); the main path runs
// fused_count_launch.

#include "reach_ring.cuh"

namespace {

using namespace rustsasa;

// csrc/reach_ring.cuh's layout; the sphere follows the ring's buffers.
constexpr int kSphereOffset = kRingSmemEnd;

template <int K, bool kRows>
__global__ void __launch_bounds__(32 * kLanes, min_ctas(K))
fused_count_kernel(const float* __restrict__ planes,   // [8, m]
                   const int32_t* __restrict__ jlist,  // [m/128, 128]
                   const float4* __restrict__ sphere,  // [p] x, y, z, valid
                   int32_t* __restrict__ out,          // [m]
                   int32_t* __restrict__ rows,         // [m/128 * 4L]
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

  // Staging: the tile's live entries in order, the barriers, the CTA's
  // atoms and the zero-padded sphere, whose point norms decide far_ok.
  if (warp == 0) {
    const int32_t* row = jlist + static_cast<int64_t>(tile) * kJlistRows;
    stage_entries<false, false>(sm, nullptr, row,
                                min(max(row[0], 0), kJlistRows - 1), n_tiles,
                                lane);
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
  int streamed = 0;
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
            chunk_keep<false>(jrec, c, gm, sm, warp, lane, far_ok);
        const uint32_t u = __ballot_sync(kFullWarp, keep != 0u);
        if (kRows) streamed += __popc(u);
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
  if (kRows && lane == 0) rows[blockIdx.x * kWarps + warp] = streamed;
}

template <int K, bool kRows>
int launch(const float* planes, const int32_t* jlist, const float4* sphere,
           int32_t* out, int32_t* rows, int m, int p, int passes,
           cudaStream_t stream) {
  const int smem = kSphereOffset + 16 * passes * kLanes * K;
  auto kernel = fused_count_kernel<K, kRows>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  }
  kernel<<<(m / kAtomTile) * kQuarters, 32 * kLanes, smem, stream>>>(
      planes, jlist, sphere, out, rows, m, p, passes);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRows>
int dispatch(const void* planes, const void* jlist, const void* sphere,
             void* out, void* rows, int m, int p, void* stream) {
  if (m <= 0 || m % kAtomTile != 0 || p <= 0 || p > kMaxPPad ||
      reinterpret_cast<uintptr_t>(planes) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int passes = (p + kLanes * kMaxK - 1) / (kLanes * kMaxK);
  const int k = (p + kLanes * passes - 1) / (kLanes * passes);
  const auto* pl = static_cast<const float*>(planes);
  const auto* jl = static_cast<const int32_t*>(jlist);
  const auto* sp = static_cast<const float4*>(sphere);
  auto* o = static_cast<int32_t*>(out);
  auto* r = static_cast<int32_t*>(rows);
  auto* st = static_cast<cudaStream_t>(stream);
  RUSTSASA_SWITCH_K(k, launch<K, kRows>(pl, jl, sp, o, r, m, p, passes, st))
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  planes: f32
// [8, m] (rows x, y, z, r_eff, gid+1), 16-byte aligned; jlist: i32
// [m/128, 128]; sphere: f32 [p, 4]; out: i32 [m].  m is a positive
// multiple of 128 and 0 < p <= 2048.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int fused_count_launch(const void* planes, const void* jlist,
                                  const void* sphere, void* out, int m,
                                  int p, void* stream) {
  return dispatch<false>(planes, jlist, sphere, out, nullptr, m, p, stream);
}

// As fused_count_launch, in the instantiation that also writes to rows
// (i32 [m/128 * 64], not null), for each warp (tile-major, 2 atoms each),
// the j-rows it streamed over all passes.
extern "C" int fused_count_rows_launch(const void* planes, const void* jlist,
                                       const void* sphere, void* out,
                                       void* rows, int m, int p,
                                       void* stream) {
  if (rows == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(planes, jlist, sphere, out, rows, m, p, stream);
}
