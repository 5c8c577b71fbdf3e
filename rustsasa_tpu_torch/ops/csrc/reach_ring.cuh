// The count kernel's reach-skip layout for NVIDIA Hopper (sm_90a), shared
// by fused_count.cu (kernel 1, whose header describes the design and
// derives keep_pair) and the studies rebuilt on it, saturation_count.cu,
// micro_count.cu, reach_count.cu, nibble_count.cu and pair64_count.cu:
//   * a CTA is 32 i-atoms of a 128-atom i-tile (kQuarters CTAs a tile),
//     an atom kLanes = 16 lanes, each holding K sphere points and their
//     running maxima in registers; a warp is kWarpAtoms = 2 atoms;
//   * the tile's live j-list entries are compacted once into shared
//     memory; their j-tiles (5 x 512 B) come through a ring of kRing
//     slots, each filled by five cp.async.bulk copies completing on the
//     slot's "full" mbarrier; each warp arrives on the slot's "empty"
//     mbarrier when done with it, and lane 0 of warp 0 (the producer)
//     refills a slot once every warp has.  Load g of a kernel's
//     passes * n_live is live entry g % n_live of pass g / n_live;
//   * for each admitted 32-row chunk of a j-tile, lane l tests row l
//     against the warp's atoms (chunk_keep), a ballot gives the rows some
//     atom keeps, and the warp streams only those (stream_rows).  The
//     chunk's rows are a map from lane to row (ChunkRows: kernel 1's 32
//     consecutive rows; OctetRows: a row base for each 8-lane octet, so
//     that four admitted 8-row groups fill one chunk).
#pragma once

#include "count_tile.cuh"

namespace rustsasa {

constexpr int kLanes = 16;                         // lanes an i-atom
constexpr int kCtaAtoms = 32;                      // i-atoms a CTA
constexpr int kQuarters = kAtomTile / kCtaAtoms;   // CTAs an i-tile
constexpr int kWarps = kCtaAtoms * kLanes / 32;    // warps a CTA
constexpr int kWarpAtoms = 32 / kLanes;            // i-atoms a warp
constexpr int kRing = 4;                           // j-tile slots
constexpr int kTileFloats = kRecords * kAtomTile;  // one slot
constexpr uint32_t kPlaneBytes = 4 * kAtomTile;
constexpr uint32_t kFullWarp = 0xFFFFFFFFu;

// Shared memory: the ring, its 2 x kRing mbarriers, the CTA's atoms
// (x, y, z, r) and gids, the compacted j-list (and its length); a
// kernel's own buffers start at kRingSmemEnd, the sphere last.
constexpr int kRingBytes = 4 * kRing * kTileFloats;
constexpr int kAtomsOffset = kRingBytes + 16 * kRing;
constexpr int kEntsOffset = kAtomsOffset + 20 * kCtaAtoms;
constexpr int kRingSmemEnd = kEntsOffset + 4 * (kJlistRows + 4);
static_assert(kAtomsOffset % 16 == 0 && kRingSmemEnd % 16 == 0,
              "float4 arrays need 16-byte alignment");

// CTAs a SM the register budget should leave room for when a thread
// holds k points' coordinates and maxima: ~4k registers, ~36 for the rest.
constexpr int min_ctas(int k) {
  return 65536 / (32 * kLanes * (4 * k + 36)) < 1
             ? 1
             : 65536 / (32 * kLanes * (4 * k + 36));
}

// Views of the layout's shared memory.
struct RingSmem {
  float* slots;
  uint64_t* full;
  uint64_t* empty;
  float4* atoms;
  float* agid;
  uint32_t* ents;
  int* n_live;
};

__device__ __forceinline__ RingSmem ring_smem(unsigned char* smem) {
  RingSmem sm;
  sm.slots = reinterpret_cast<float*>(smem);
  sm.full = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  sm.empty = sm.full + kRing;
  sm.atoms = reinterpret_cast<float4*>(smem + kAtomsOffset);
  sm.agid = reinterpret_cast<float*>(sm.atoms + kCtaAtoms);
  sm.ents = reinterpret_cast<uint32_t*>(smem + kEntsOffset);
  sm.n_live = reinterpret_cast<int*>(sm.ents + kJlistRows);
  return sm;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem_u32(bar))
      : "memory");
}

// True once the phase of parity `parity` has completed; does not block.
__device__ __forceinline__ bool bar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0u;
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (done == 0u);
}

// j-tile jt's five 512-byte plane rows into `slot`, completing on `bar`.
__device__ __forceinline__ void fill_slot(float* slot, uint64_t* bar,
                                          const float* __restrict__ planes,
                                          int64_t mm, int jt) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(
          smem_u32(bar)),
      "r"(kRecords * kPlaneBytes)
      : "memory");
  const float* src = planes + static_cast<int64_t>(jt) * kAtomTile;
#pragma unroll
  for (int k = 0; k < kRecords; ++k) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(slot + k * kAtomTile)),
        "l"(src + k * mm), "r"(kPlaneBytes), "r"(smem_u32(bar))
        : "memory");
  }
}

// The producer, before its warp consumes load g of the `total` loads:
// issues the loads after `next` up to g + kRing - 1 whose slot every warp
// has released, waiting only for load g itself.  With kNull, a load whose
// live position is at or past its pass's stop[pass] (a pass that stopped
// early) copies nothing: the producer completes its "full" phase alone.
// Returns the next load to issue.
template <bool kNull>
__device__ __forceinline__ int produce(int g, int next, int total,
                                       const RingSmem& sm, int n_live,
                                       const float* __restrict__ planes,
                                       int64_t mm, const int* stop) {
  while (next < total && next < g + kRing) {
    const int s = next % kRing;
    if (next >= kRing) {
      const uint32_t parity = (next / kRing - 1) & 1;
      if (next == g) {
        bar_wait(&sm.empty[s], parity);
      } else if (!bar_test(&sm.empty[s], parity)) {
        break;
      }
    }
    if (kNull && next % n_live >= stop[next / n_live]) {
      bar_arrive(&sm.full[s]);
    } else {
      fill_slot(sm.slots + s * kTileFloats, &sm.full[s], planes, mm,
                static_cast<int>(sm.ents[next % n_live] & 0xFFFFu));
    }
    ++next;
  }
  return next;
}

// Staging by warp 0: the tile's live entries in order into sm.ents (with
// their j-list positions into pos where kPos), their count, and the
// ring's barriers.  An entry is live when its j-tile is in the chunk and,
// unless kAnyMask, some group bit is set.  With kMaskRow an entry's group
// bits are the low 16 bits of mask_row's cell in place of its own high
// 16 (pair64_count.cu's mask B), staged as (mask << 16) | j_tile.
template <bool kAnyMask, bool kPos, bool kMaskRow = false>
__device__ __forceinline__ void stage_entries(const RingSmem& sm,
                                              uint8_t* pos,
                                              const int32_t* row,
                                              int n_entries, int n_tiles,
                                              int lane,
                                              const int32_t* mask_row =
                                                  nullptr) {
  int n = 0;
  for (int e0 = 0; e0 < n_entries; e0 += 32) {
    const int e = e0 + lane;
    uint32_t ent = e < n_entries ? static_cast<uint32_t>(row[1 + e]) : 0u;
    if constexpr (kMaskRow) {
      ent = (ent & 0xFFFFu) |
            (e < n_entries ? static_cast<uint32_t>(mask_row[1 + e]) << 16
                           : 0u);
    }
    const bool live = (kAnyMask ? e < n_entries : (ent >> 16) != 0u) &&
                      static_cast<int>(ent & 0xFFFFu) < n_tiles;
    const uint32_t b = __ballot_sync(kFullWarp, live);
    if (live) {
      const int at = n + __popc(b & ((1u << lane) - 1u));
      sm.ents[at] = ent;
      if (kPos) pos[at] = static_cast<uint8_t>(e);
    }
    n += __popc(b);
  }
  if (lane == 0) {
    *sm.n_live = n;
    for (int s = 0; s < kRing; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
}

// Staging by the first 32 threads: the CTA's atoms (x, y, z, r) and gids.
__device__ __forceinline__ void stage_atoms(const RingSmem& sm,
                                            const float* __restrict__ planes,
                                            int64_t mm, int64_t atom0,
                                            int tid) {
  if (tid < kCtaAtoms) {
    const int64_t i = atom0 + tid;
    sm.atoms[tid] = make_float4(planes[i], planes[mm + i], planes[2 * mm + i],
                                planes[3 * mm + i]);
    sm.agid[tid] = planes[4 * mm + i];
  }
}

// Staging by every thread: the sphere's first n_cover points, zero-padded,
// into sph; false where a valid point this thread staged is longer than
// the distance skip allows (|s|^2 > kUnitNorm2).
__device__ __forceinline__ bool stage_sphere_norms(
    float4* sph, const float4* __restrict__ sphere, int p, int n_cover,
    int tid) {
  bool sphere_ok = true;
  for (int k = tid; k < n_cover; k += 32 * kLanes) {
    const float4 s = k < p ? sphere[k] : make_float4(0.f, 0.f, 0.f, 0.f);
    sph[k] = s;
    if (s.w > 0.0f && !(point_norm2(s) <= kUnitNorm2)) sphere_ok = false;
  }
  return sphere_ok;
}

// Lane l of a chunk tests and streams row c * 32 + l of the staged tile.
struct ChunkRows {
  int c;
  __device__ __forceinline__ int row(int lane) const { return c * 32 + lane; }
};

// Lanes 8o..8o+7 of a chunk take rows 8g..8g+7 of group g = (groups >>
// 4o) & 0xF: four 8-row groups, named by their 4-bit ids, in one chunk.
struct OctetRows {
  uint32_t groups;
  __device__ __forceinline__ int row(int lane) const {
    return kJGroup * static_cast<int>((groups >> (4 * (lane >> 3))) & 0xFu) +
           (lane & (kJGroup - 1));
  }
};

// The keep test a chunk runs: keep_pair (kernel 1), keep_row, or keep_row
// with the slack of bf16 margins (count_tile.cuh).
enum KeepTest { kKeepPair = 0, kKeepRow, kKeepRowBf16 };

// Bit a of lane l's result: whether atom a of the warp keeps row
// rows.row(l) of the staged j-tile (by test kTest), false where the lane
// is not `active`.
template <int kTest, typename Rows>
__device__ __forceinline__ uint32_t rows_keep(const float* jrec, Rows rows,
                                              bool active, const RingSmem& sm,
                                              int warp, int lane,
                                              bool far_ok) {
  const int r = rows.row(lane);
  uint32_t keep = 0u;
  if (active) {
    const float jx = jrec[r];
    const float jy = jrec[kAtomTile + r];
    const float jz = jrec[2 * kAtomTile + r];
    const float jr = jrec[3 * kAtomTile + r];
    const float jg = jrec[4 * kAtomTile + r];
#pragma unroll
    for (int a = 0; a < kWarpAtoms; ++a) {
      const int ca = warp * kWarpAtoms + a;
      const bool k =
          kTest == kKeepPair
              ? keep_pair(sm.atoms[ca], sm.agid[ca], jx, jy, jz, jr, jg,
                          far_ok)
              : keep_row(sm.atoms[ca], sm.agid[ca], jx, jy, jz, jr, jg,
                         far_ok,
                         kTest == kKeepRowBf16 ? kBf16Slack : kReachSlack);
      keep |= static_cast<uint32_t>(k) << a;
    }
  }
  return keep;
}

// rows_keep over chunk c, lane l active where the row's group bit in gm
// (chunk c's four bits) is set: keep_pair, or with kExact keep_row.
template <bool kExact>
__device__ __forceinline__ uint32_t chunk_keep(const float* jrec, int c,
                                               uint32_t gm,
                                               const RingSmem& sm, int warp,
                                               int lane, bool far_ok) {
  return rows_keep<kExact ? kKeepRow : kKeepPair>(
      jrec, ChunkRows{c}, ((gm >> (lane >> 3)) & 1u) != 0u, sm, warp, lane,
      far_ok);
}

// Row rows.row(b) for this lane's atom (bit a_local of lane b's keep):
// v, and lim, -1e30 where the atom does not keep the row.
template <typename Rows>
__device__ __forceinline__ float rows_lim(const float* jrec, Rows rows, int b,
                                          uint32_t keep, int a_local,
                                          const IAtom& at, float& vx,
                                          float& vy, float& vz) {
  const bool mine = (__shfl_sync(kFullWarp, keep, b) >> a_local) & 1u;
  return row_lim_kept(jrec, rows.row(b), at, mine, vx, vy, vz);
}

// Streams the rows of a chunk set in the ballot u, one an iteration
// (uniform over the warp: no divergence).
template <int K, typename Rows>
__device__ __forceinline__ void stream_rows(uint32_t u, uint32_t keep,
                                            const float* jrec, Rows rows,
                                            int a_local, const IAtom& at,
                                            const float (&sx)[K],
                                            const float (&sy)[K],
                                            const float (&sz)[K],
                                            float (&occ)[K]) {
  while (u != 0u) {
    const int b = __ffs(u) - 1;
    u &= u - 1u;
    float vx, vy, vz;
    const float lim = rows_lim(jrec, rows, b, keep, a_local, at, vx, vy, vz);
    row_margins<K>(vx, vy, vz, lim, sx, sy, sz, occ);
  }
}

}  // namespace rustsasa
