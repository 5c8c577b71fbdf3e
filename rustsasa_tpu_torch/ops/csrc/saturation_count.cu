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
// The rule, per point pass (kernel 1's split: lane q of an atom holds
// points [(pass*16 + q)*K, (pass*16 + q + 1)*K)):
//   * a valid point's running max margin starts at -1e30, a pad point's
//     (valid = 0, or past the sphere's end) at +1, so pad points never
//     hold the check back;
//   * after entry e (its position in the j-list, live or not), when e %
//     check_every == check_every - 1, the tile is done with the pass if
//     its margins are > 0 at all the pass's points of all 128 atoms,
//     padding atoms included, and streams no further entry of it;
//   * streamed[tile] sums over the passes the entries each went through.
//
// Design: kernel 1's reach-skip layout (reach_ring.cuh), a tile being
// kQuarters = 4 CTAs of 32 atoms.  The skip keeps the rule exact: a row
// that keep_row leaves out has all its rounded margins <= 0
// (count_tile.cuh), and a max with a value <= 0 never changes whether a
// running max is > 0, so the stop entry, the counts and `streamed` are
// those of streaming every admitted row.  keep_row, unlike kernel 1's
// keep_pair, keeps padding atoms' rows (their margins are part of the
// check, and their counts stay the reference's).
//
// The check.  Margins only grow, so a warp saturated at a checked entry
// stays so, and the tile is saturated at check c iff each of its 64
// warps is, i.e. iff c is at or past every warp's first saturated check:
// the pass stops after the largest of those.  A warp votes at each
// checked entry until it is saturated, then reports once into the tile's
// counters in device memory (`sync`, zeroed by the caller): a max of
// that check's position, then (release) one more on the pass's count of
// saturated warps.  A saturated warp polls the count (acquire) at each
// later check; at 64 it reads the largest position and streams no entry
// past it.  Nothing holds the loop: an unsaturated warp pays a vote a
// check, a saturated one a load from L2.  A warp that learns of the stop
// a check late has streamed an entry more, which cannot move a count: by
// then every atom of the tile is saturated.  The tile's last CTA to
// finish (a count of finished CTAs) reads the counters and writes
// `streamed`, which is so the rule's exactly.  Entries past a stop are
// null loads: the producer completes their "full" phase without a copy,
// and the warps release them unread.  A pass whose points are all pad
// points is saturated before its first entry: it stops at its first
// checked entry, known to every warp without a vote.  The checked
// positions are tabled once per CTA, a byte per live entry.
//
// Bound: FP32 issue, as fused_count.cu, on the work the inputs need
// (chip_smoke.recount_bound).  Two designs with a tile as a cluster of
// the 4 CTAs, the counters in rank 0's shared memory, ran 1.32-1.64x
// kernel 1 at 0.5M on a chunk where no tile saturates (PERF.md): a
// cluster barrier at every checked entry, or one at the end only, which
// still holds a finished CTA's SM slot until its tile's slowest CTA is
// done.

#include "reach_ring.cuh"

namespace {

using namespace rustsasa;

// Point passes of up to kLanes x kMaxK points a sphere of kMaxPPad needs.
constexpr int kMaxPasses = (kMaxPPad + kLanes * kMaxK - 1) / (kLanes * kMaxK);
// Warps of a tile.
constexpr uint32_t kTileWarps = kQuarters * kWarps;
// A tile's words of `sync`: each pass's count of saturated warps, each
// pass's largest first saturated check, the count of finished CTAs.
constexpr int kSyncWords = 2 * kMaxPasses + 1;
// No check after this live entry (chk[]).
constexpr uint8_t kNoCheck = 0xFF;
// Shared memory after the ring's: the live entries' j-list positions and
// the checked position after each, each pass's live entries to stream
// (the producer's copy), a bit per pass with a valid point, the sphere.
constexpr int kPosOffset = kRingSmemEnd;
constexpr int kChkOffset = kPosOffset + kJlistRows;
constexpr int kStopOffset = kChkOffset + kJlistRows;
constexpr int kValidOffset = kStopOffset + 4 * kMaxPasses;
constexpr int kSphereOffset = kValidOffset + 16;
static_assert(kSphereOffset % 16 == 0, "float4 arrays need 16-byte alignment");

__device__ __forceinline__ void max_gpu(uint32_t* ptr, uint32_t v) {
  asm volatile("red.relaxed.gpu.global.max.u32 [%0], %1;" ::"l"(ptr), "r"(v)
               : "memory");
}

// Adds v; release, so the caller's earlier writes are seen with it, and
// acquire.  Returns the value before.
__device__ __forceinline__ uint32_t add_gpu(uint32_t* ptr, uint32_t v) {
  uint32_t old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(ptr), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ uint32_t load_gpu(const uint32_t* ptr) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(ptr)
               : "memory");
  return v;
}

// Where a pass stops before any check: (entries streamed, live entries
// to stream).  A pass with a valid point goes through all n_entries; one
// with none is saturated from the start and stops at its first checked
// entry, min(check_every, n_entries), after the live entries before it.
__device__ __forceinline__ int2 first_stop(bool has_valid, int n_entries,
                                           int n_live, const uint8_t* pos,
                                           int check_every) {
  if (has_valid) return make_int2(n_entries, n_live);
  const int stop = min(check_every, n_entries);
  int live = 0;
  while (live < n_live && pos[live] < stop) ++live;
  return make_int2(stop, live);
}

template <int K>
__global__ void __launch_bounds__(32 * kLanes, min_ctas(K))
saturation_count_kernel(const float* __restrict__ planes,   // [8, m]
                        const int32_t* __restrict__ jlist,  // [m/128, 128]
                        const float4* __restrict__ sphere,  // [p]
                        int32_t* __restrict__ out,          // [m]
                        int32_t* __restrict__ streamed,     // [m/128]
                        uint32_t* __restrict__ sync,  // [m/128, kSyncWords]
                        int m, int p, int passes, int check_every) {
  constexpr int L = kLanes;
  extern __shared__ __align__(128) unsigned char smem[];
  const RingSmem sm = ring_smem(smem);
  uint8_t* pos = smem + kPosOffset;
  uint8_t* chk = smem + kChkOffset;
  int* stop_sh = reinterpret_cast<int*>(smem + kStopOffset);
  uint32_t* valid_sh = reinterpret_cast<uint32_t*>(smem + kValidOffset);
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
  const int32_t* row = jlist + static_cast<int64_t>(tile) * kJlistRows;
  const int n_entries = min(max(row[0], 0), kJlistRows - 1);
  uint32_t* n_sat = sync + static_cast<int64_t>(tile) * kSyncWords;
  uint32_t* last = n_sat + kMaxPasses;
  uint32_t* done = last + kMaxPasses;

  // Staging: warp 0 the live entries, their positions and checks and the
  // barriers; warp 1 which passes have a valid point.
  if (warp == 0) {
    stage_entries<false, true>(sm, pos, row, n_entries, n_tiles, lane);
    __syncwarp();
    const int n = *sm.n_live;
    for (int i = lane; i < n; i += 32) {
      // The first checked position at or after this entry's; the state
      // holds until the next live entry's position (or the list's end).
      const int ei = pos[i];
      const int c = ei + (check_every - 1 - ei % check_every);
      chk[i] = c < (i + 1 < n ? pos[i + 1] : n_entries)
                   ? static_cast<uint8_t>(c)
                   : kNoCheck;
    }
  } else if (warp == 1) {
    uint32_t has = 0u;
    for (int ps = 0; ps < passes; ++ps) {
      bool any = false;
      for (int k = lane; k < L * K; k += 32) {
        const int pt = ps * L * K + k;
        any = any || (pt < p && sphere[pt].w > 0.0f);
      }
      has |= static_cast<uint32_t>(__any_sync(kFullWarp, any)) << ps;
    }
    if (lane == 0) *valid_sh = has;
  }
  stage_atoms(sm, planes, mm, atom0, tid);
  const bool far_ok =
      __syncthreads_and(stage_sphere_norms(sph, sphere, p, n_cover, tid)) != 0;
  const int n_live = *sm.n_live;
  const uint32_t has_valid = *valid_sh;
  if (tid == 0) {
    for (int ps = 0; ps < passes; ++ps) {
      stop_sh[ps] = first_stop((has_valid >> ps) & 1u, n_entries, n_live,
                               pos, check_every).y;
    }
  }

  const int total = passes * n_live;
  const int cta_atom = warp * kWarpAtoms + a_local;
  const IAtom at = load_i_atom(planes, mm, atom0 + cta_atom);

  int next = 0;  // the producer's next load
  int g = 0;     // this warp's load
  int accessible = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int p0 = (pass * L + q) * K;
    float sx[K], sy[K], sz[K], occ[K];
    load_points<K>(sph, p0, 1.0f, sx, sy, sz, occ);
    bool checking = (has_valid >> pass) & 1u;
    int live_end =  // live entries the warp streams
        first_stop(checking, n_entries, n_live, pos, check_every).y;
    bool saturated = false;  // this warp, at a checked entry
    for (int e = 0; e < n_live; ++e, ++g) {
      const int s = g % kRing;
      if (tid == 0) {
        next = produce<true>(g, next, total, sm, n_live, planes, mm,
                             stop_sh);
      }
      __syncwarp();
      bar_wait(&sm.full[s], (g / kRing) & 1);
      if (e < live_end) {
        const float* jrec = sm.slots + s * kTileFloats;
        const uint32_t mask = sm.ents[e] >> 16;
#pragma unroll 1
        for (int c = 0; c < kAtomTile / 32; ++c) {
          const uint32_t gm = (mask >> (4 * c)) & 0xFu;
          if (gm == 0u) continue;  // uniform over the warp
          const uint32_t keep =
              chunk_keep<true>(jrec, c, gm, sm, warp, lane, far_ok);
          const uint32_t u = __ballot_sync(kFullWarp, keep != 0u);
          stream_rows<K>(u, keep, jrec, ChunkRows{c}, a_local, at, sx, sy,
                         sz, occ);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&sm.empty[s]);
      const uint8_t c = chk[e];
      if (!checking || c == kNoCheck) continue;
      uint32_t n = 0u;
      if (!saturated) {
        bool sat = true;
#pragma unroll
        for (int k = 0; k < K; ++k) sat = sat && occ[k] > 0.0f;
        saturated = __all_sync(kFullWarp, sat);
        if (!saturated) continue;
        if (lane == 0) {
          max_gpu(&last[pass], c);
          n = add_gpu(&n_sat[pass], 1u) + 1u;
        }
      } else if (lane == 0) {
        n = load_gpu(&n_sat[pass]);
      }
      if (__shfl_sync(kFullWarp, n, 0) < kTileWarps) continue;
      // Every warp of the tile is saturated: the pass stops after the
      // largest first saturated check; stream the live entries up to it.
      const int stop = static_cast<int>(__shfl_sync(
          kFullWarp, lane == 0 ? load_gpu(&last[pass]) : 0u, 0));
      live_end = e + 1;
      while (live_end < n_live && pos[live_end] <= stop) ++live_end;
      checking = false;
      if (tid == 0) stop_sh[pass] = live_end;
    }
    accessible += count_accessible<K>(sph, p0, occ);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    accessible += __shfl_xor_sync(kFullWarp, accessible, off);
  }
  if (q == 0) out[atom0 + cta_atom] = accessible;
  // Every warp's reports are in before this CTA counts itself finished;
  // the tile's last CTA reads each pass's stop.
  __syncthreads();
  if (tid == 0 && add_gpu(done, 1u) == kQuarters - 1) {
    int n_streamed = 0;
    for (int ps = 0; ps < passes; ++ps) {
      const bool has = (has_valid >> ps) & 1u;
      n_streamed +=
          !has ? first_stop(has, n_entries, n_live, pos, check_every).x
          : load_gpu(&n_sat[ps]) == kTileWarps
              ? static_cast<int>(load_gpu(&last[ps])) + 1
              : n_entries;
    }
    streamed[tile] = n_streamed;
  }
}

template <int K>
int launch(const float* planes, const int32_t* jlist, const float4* sphere,
           int32_t* out, int32_t* streamed, uint32_t* sync, int m, int p,
           int passes, int check_every, cudaStream_t stream) {
  const int smem = kSphereOffset + 16 * passes * kLanes * K;
  auto kernel = saturation_count_kernel<K>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  }
  kernel<<<(m / kAtomTile) * kQuarters, 32 * kLanes, smem, stream>>>(
      planes, jlist, sphere, out, streamed, sync, m, p, passes, check_every);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  planes: f32
// [8, m] (rows x, y, z, r_eff, gid+1), 16-byte aligned; jlist: i32
// [m/128, 128]; sphere: f32 [p, 4]; out: i32 [m]; streamed: i32 [m/128];
// sync: i32 [m/128, 17], zeros.  m is a positive multiple of 128, 0 < p
// <= 2048 and check_every >= 1.  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int saturation_count_launch(const void* planes, const void* jlist,
                                       const void* sphere, void* out,
                                       void* streamed, void* sync, int m,
                                       int p, int check_every, void* stream) {
  if (m <= 0 || m % kAtomTile != 0 || p <= 0 || p > kMaxPPad ||
      check_every < 1 || reinterpret_cast<uintptr_t>(planes) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int passes = (p + kLanes * kMaxK - 1) / (kLanes * kMaxK);
  const int k = (p + kLanes * passes - 1) / (kLanes * passes);
  RUSTSASA_SWITCH_K(
      k, launch<K>(static_cast<const float*>(planes),
                   static_cast<const int32_t*>(jlist),
                   static_cast<const float4*>(sphere),
                   static_cast<int32_t*>(out), static_cast<int32_t*>(streamed),
                   static_cast<uint32_t*>(sync), m, p, passes, check_every,
                   static_cast<cudaStream_t>(stream)))
}
