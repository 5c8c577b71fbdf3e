// Neighbor phase of the list path for NVIDIA Hopper (sm_90a), plain C
// interface: the cell binning and ordering (cell_keys) and a cell list
// that writes the occlusion kernel's K-major records (neighbor_cells).
//
// Replaces the XLA device code of the JAX package's list path,
// rustsasa_tpu/ops/engine.py:138-211 (_neighbor_phase: a full-FP32
// [rows, N] d^2 expansion, a cutoff mask, lax.top_k of the K nearest and
// a gather of v and the limits), for a whole [B, N] batch.
//
// ops/neighbors.py, neighbor_records, launches two functions on the card:
//   1. cell_keys, two kernels (one launch count):
//      a. cell_keys_kernel: each structure's largest real radius max_r,
//         cell edge h and lowest corner, then each atom's cell key
//         (structure << 54 | cell x << 36 | cell y << 18 | cell z;
//         padding INT64_MAX), all in f64 as neighbors.cell_grid computes
//         them, bit for bit, and each structure's real atoms and occupied
//         cells an axis;
//      b. cell_order_kernel: the keys' stable sort (sorted keys and perm,
//         equal to torch.sort(keys, stable=True)'s) with packed and gid
//         gathered into that order, so a cell's atoms are contiguous
//         float4s.  The sort is the port's bookkeeping: the reference's
//         arithmetic has no counterpart for it;
//   2. neighbor_cells: the records [4][K][m4] (vx, vy, vz, limit planes,
//      K-major, m4 = B*N rounded up to 4), counts [B*N] and max_count.
//
// cell_keys_kernel.  One cluster a structure, of one CTA for each 2,048
// slots up to kCluster = 8 (cluster_ctas; 8 for 1jz8): each CTA reduces
// its share of the structure's atoms (max radius, f32 corners,
// the f64 r2 = (x*x + y*y) + z*z, the real atoms), the CTAs read one
// another's partials through distributed shared memory, and each
// computes the edge and its atoms' keys.  The structure's occupied cells
// an axis are n = cell(hi) + 1 from its highest corner hi: cell(c) =
// floor((c - lo) / h), each step rounded once, is monotone in c, and the
// lowest corner's cell is 0.
//
// cell_order_kernel.  The same clusters, each of the structure's warps
// (8 a CTA) owning a run of consecutive slots.
// Within a structure the key orders as the dense cell index d = (cx ny +
// cy) nz + cz < C = nx ny nz (mixed radix), a padding slot taking d = C,
// so a stable sort by d is the keys' stable sort.  d needs bits(C) bits,
// sorted in LSD passes of at most 8 bits (two of 7 for 1jz8's 14), up to
// 55 bits in 7 passes (2^18 cells an axis; the edge's D2_ERR term keeps
// h >= 2^-9.5 max |c|, so a batch binned here has at most ~2^10.5 cells
// an axis and takes at most 4 passes); each pass is stable:
//   * each warp counts its run's digits (__match_any_sync over 32 slots
//     a step; the group's lowest lane adds for it) into its own 256 bins
//     in shared memory;
//   * a slot's place is the slots of lower digits in the structure, plus
//     those of its digit in lower warps - the warps before it in its CTA,
//     then the CTAs before it, whose totals each CTA reads through
//     distributed shared memory - plus those before it in its own warp
//     (its lanes below it in the step, the steps before);
//   * a warp holds kSteps steps of its run in registers, loaded together
//     (its whole run, from one load a pass, for N <= 32,768); the (key,
//     slot) pairs go through a device scratch buffer of 2 x B*N pairs
//     between passes (12 bytes a slot each; L2-resident for 1jz8's 0.4 MB
//     a buffer), read and written past L1.  Shared memory holds only the
//     bins, so no N is too large for it.  On 1jz8 a pass takes ~0.013 ms
//     (scripts/layout_probe.py's cut builds; PERF.md).
// The last pass writes each slot to its place in the batch: structure
// s's real atoms start after the real atoms of the structures before it
// (each CTA sums the first kernel's counts, B <= 511 of them), and every
// padding slot follows all real ones, in index order, as the stable sort
// of the whole batch puts them.  Bound: bytes (packed and gid read; keys,
// sorted keys, perm, sorted packed and sorted gid written: 64 an atom).
//
// neighbor_cells.  A CTA owns kRows consecutive rows i (atom slots in index
// order: a protein's consecutive atoms share cells), one warp a row.
//   * Lanes 0-8 find the lower ends and lanes 9-17 the upper ends of the
//     row's nine cell columns in the sorted keys in parallel (binary
//     searches): for dx, then dy in -1..1, the column of cells z-1..z+1.
//     Laid end to end, the nine ranges are the row's visit order: the
//     column order, each column's atoms in sorted order (the sort is
//     stable).  Consecutive rows often share a cell: only the first row
//     of each run of the CTA's rows in one cell searches, into shared
//     memory, and the run reads its ranges after a barrier.
//   * The warp walks the ranges 32 atoms a step, lane l the step's l-th
//     atom, reading the sorted float4s side by side (the next step's
//     loaded before this step's are tested), and tests each j as the
//     plain version does:
//       sq = (x*x + y*y) + z*z,
//       cross = fma(z_i, z_j, fma(y_i, y_j, x_i*x_j)),
//       d2 = max((sq_i + sq_j) - 2*cross, 0),
//       cutoff = (r_i + max_r) + 2 probe,
//       candidate iff gid_i != gid_j and d2 <= cutoff*cutoff + 1e-3
//     (j's key says it is real and of i's structure).  A candidate's slot
//     is the candidates before it in visit order: the count of earlier
//     steps plus the popcount of the lower lanes' ballot bits, so a
//     row's records lie in visit order (the CPU model of
//     tests/test_torch_neighbor_cells.py).
//   * A kept candidate's sorted position is staged in shared memory,
//     [Ks][kRows] for the slots below Ks = min(K, kStageCap).  After a
//     barrier a thread takes a (slot, 4 rows), makes the rows' records
//     from the staged positions - v = c_i - c_j, v2 = (vx*vx + vy*vy) +
//     vz*vz, nr = r_j + probe, reff = r_i + probe, limit = ((nr*nr - v2)
//     - reff*reff) / (2*reff) - and writes each plane's four with one
//     16-byte store, so a (plane, slot) is kRows consecutive floats
//     (whole 32-byte sectors), the slots past a row's records (0, 0, 0,
//     -1e30).  The scan's steps thus carry no record arithmetic.  A slot
//     at or past Ks gets its record from the row's warp, straight to
//     device memory, so shared memory does not bound K.
//   * Every operation is an explicitly rounded intrinsic in the order
//     above (the library is also built with --fmad=false); the cross term
//     is the one fused chain that the reference's HIGHEST dot (and the
//     plain version's fma.dot3) computes.  So the records equal the plain
//     version's bit for bit.
//   * counts[i] is the number of candidates.  When it is <= K the row's
//     records are its candidates in visit order and the remaining slots
//     (0, 0, 0, -1e30).  When it is > K the row keeps the K nearest, as
//     top_k keeps them: the K smallest (d2 bits, j) keys (ties to the
//     lower index j, the atom's index by perm), found by a bitwise search
//     over the key's 63 bits in which the warp rescans the ranges once a
//     bit - a slow path for rows whose batch the caller re-runs with a
//     larger K.  Padding rows and the columns past B*N get count 0 and K
//     records that never occlude.  max_count is an atomicMax a CTA.
//
// Why the 27 cells hold every candidate.  With u = 2^-24 and |c| <= R
// for the structure's real atoms:
//   |sq - |c|^2| <= 3.01 u R^2         (three products, two adds of
//                                        nonnegative terms),
//   |cross - c_i.c_j| <= 3.01 u R^2    (one product, two fused adds),
//   |fl(sq_i + sq_j) - (sq_i + sq_j)| <= 2.01 u R^2, and 2*cross is exact,
// so (sq_i + sq_j) - 2*cross is within (2.01 + 2 x 3.01 + 2 x 3.01) u R^2
// = 14.04 u R^2 of D^2 = |c_i - c_j|^2, and d2 within 14.04 u R^2 + u D^2
// after its own rounding (the clamp at 0 only moves d2 toward D^2).  A
// candidate has d2 <= thr_i <= thr (1 + 6u), thr = (2 max_r + 2 probe)^2
// + 1e-3 in exact arithmetic, so D^2 (1 - u) <= thr (1 + 6u) + 14.04 u
// R^2, and D^2 < thr + 32 u (R^2 + thr) = h^2 / (1 + 2^-20) with the cell
// edge h below (D2_ERR = 32 u, H_SLACK = 2^-20).  Each axis of c_i - c_j
// is then under h (1 - 2^-22); with the cells computed in f64 (relative
// error ~1e-16, at most 2^18 cells an axis) the two atoms' cells differ by
// at most one on every axis.  The bound grows with R^2 - ~0.02 A^2 at |c|
// ~ 100 A, ~3 A^2 at 1,300 A - and h with it: the list path sets no limit
// on a structure's extent.
//
// Bound: bytes.  The records are K x m4 x 16 bytes (84 MB for 1jz8 at K =
// 160) against ~13 FP32 operations a visited pair and ~13 a record (283
// and 49 an atom on 1jz8).  So the stores are written as whole sectors,
// a warp a row keeps the SMs full of rows (32,768 warps for 1jz8), and
// the sorted gather takes the permutation out of each pair's chain of
// loads.  What is left is latency: each leader's dependent search loads
// and each row's ~9 steps, ahead of the CTA's barrier
// (scripts/layout_probe.py times builds with the stores, the steps or
// the whole scan cut out).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCellBits = 18;
constexpr int kCellMax = (1 << kCellBits) - 1;
constexpr int kStructShift = 3 * kCellBits;
constexpr int kMaxBatch = 511;  // _kernels.MAX_CELL_BATCH
constexpr int64_t kPadKey = INT64_MAX;
constexpr float kNegBig = -1e30f;
constexpr float kCutoffSlack = 1e-3f;
constexpr unsigned kFull = 0xffffffffu;

// neighbor_cells: rows a CTA (one warp each), the slots staged in shared
// memory (256 x 16 sorted positions = 16 KB at most), and CTAs an SM:
// three cap a thread at 40 registers, 48 warps an SM to hide the
// searches' and steps' load latency (scripts/layout_probe.py times the
// uncapped build, two CTAs an SM).
constexpr int kRows = 16;
constexpr int kThreads = 32 * kRows;
constexpr int kStageCap = 256;
constexpr int kMinCtas = 3;
constexpr int kColumns = 9;
constexpr int kWays = 4;  // parts a search step splits its range into

// cell_keys: the most CTAs a structure (one cluster), the slots that
// take one more (cluster_ctas), threads a CTA; the cell edge's slack
// (neighbors.D2_ERR, 1 + neighbors.H_SLACK).
constexpr int kCluster = 8;
constexpr int kClusterSlots = 2048;
constexpr int kKeyThreads = 256;
constexpr int kKeyUnroll = 4;  // atoms a thread loads at once
constexpr double kD2Err = 1.0 / (1 << 19);
constexpr double kHSlack = 1.0 + 1.0 / (1 << 20);
// cell_order: warps a CTA (kKeyThreads threads, one run of slots each),
// the bins of a digit pass (at most 8 bits).
constexpr int kOrderWarps = kKeyThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kSteps = 16;  // 32-slot steps a warp holds in registers
static_assert(kBins == kKeyThreads, "a thread a bin");

// ---------------------------------------------------------------- cell_keys

// A part of a structure's real atoms: the largest radius (0 if none),
// the f32 corners, the largest (x*x + y*y) + z*z in f64, and how many.
struct Extent {
  float max_r;
  float lo[3];
  float hi[3];
  double r2;
  int n;
};

__device__ __forceinline__ void empty_extent(Extent& e) {
  e.max_r = 0.0f;
  for (int a = 0; a < 3; ++a) {
    e.lo[a] = __int_as_float(0x7f800000);  // +inf
    e.hi[a] = __int_as_float(0xff800000);  // -inf
  }
  e.r2 = 0.0;
  e.n = 0;
}

__device__ __forceinline__ void merge(Extent& e, const Extent& o) {
  e.max_r = fmaxf(e.max_r, o.max_r);
  for (int a = 0; a < 3; ++a) {
    e.lo[a] = fminf(e.lo[a], o.lo[a]);
    e.hi[a] = fmaxf(e.hi[a], o.hi[a]);
  }
  e.r2 = fmax(e.r2, o.r2);
  e.n += o.n;
}

__device__ __forceinline__ Extent shfl_extent(const Extent& e, int delta) {
  Extent o;
  o.max_r = __shfl_down_sync(kFull, e.max_r, delta);
  for (int a = 0; a < 3; ++a) {
    o.lo[a] = __shfl_down_sync(kFull, e.lo[a], delta);
    o.hi[a] = __shfl_down_sync(kFull, e.hi[a], delta);
  }
  o.r2 = __shfl_down_sync(kFull, e.r2, delta);
  o.n = __shfl_down_sync(kFull, e.n, delta);
  return o;
}

// The cell of coordinate c on an axis from the structure's lowest corner
// lo: floor((c - lo) / h), each step rounded once, clamped to [0,
// kCellMax]; monotone in c.
__device__ __forceinline__ int cell_of(double c, double lo, double h) {
  const double q = floor(__ddiv_rn(__dsub_rn(c, lo), h));
  return static_cast<int>(fmin(fmax(q, 0.0), static_cast<double>(kCellMax)));
}

// The CTAs of a structure's cluster in both kernels: one for each
// kClusterSlots of its n slots, at most kCluster (a batch of small
// structures takes one CTA each, not kCluster mostly idle ones).
int cluster_ctas(int n) {
  const int ctas = (n - 1) / kClusterSlots + 1;
  return ctas < kCluster ? ctas : kCluster;
}

__global__ void __launch_bounds__(kKeyThreads)
cell_keys_kernel(const float4* __restrict__ packed,
                 const int* __restrict__ gid, int n, double two_probe,
                 int64_t* __restrict__ keys, float* __restrict__ max_r_out,
                 double* __restrict__ h_out, int4* __restrict__ grid_out) {
  __shared__ Extent warps[kKeyThreads / 32];
  __shared__ Extent part;     // this CTA's atoms, read by the cluster
  __shared__ double cell[4];  // lo x, y, z and h of the structure
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int s = blockIdx.x / ctas;
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t base = static_cast<int64_t>(s) * n;
  const int per = (n + ctas - 1) / ctas;
  const int first = rank * per;
  const int last = min(n, first + per);

  // Atoms kKeyUnroll at a time, their loads issued together.
  Extent e;
  empty_extent(e);
  for (int i0 = first + threadIdx.x; i0 < last;
       i0 += kKeyUnroll * kKeyThreads) {
    int g[kKeyUnroll];
    float4 cs[kKeyUnroll];
#pragma unroll
    for (int u = 0; u < kKeyUnroll; ++u) {
      const int i = i0 + u * kKeyThreads;
      g[u] = i < last ? __ldg(gid + base + i) : -1;
      cs[u] = i < last ? __ldg(packed + base + i)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kKeyUnroll; ++u) {
      if (g[u] < 0) continue;
      const float4 c = cs[u];
      const double x = c.x, y = c.y, z = c.z;
      e.max_r = fmaxf(e.max_r, c.w);
      e.lo[0] = fminf(e.lo[0], c.x);
      e.lo[1] = fminf(e.lo[1], c.y);
      e.lo[2] = fminf(e.lo[2], c.z);
      e.hi[0] = fmaxf(e.hi[0], c.x);
      e.hi[1] = fmaxf(e.hi[1], c.y);
      e.hi[2] = fmaxf(e.hi[2], c.z);
      e.r2 = fmax(e.r2, __dadd_rn(__dadd_rn(__dmul_rn(x, x),
                                            __dmul_rn(y, y)),
                                  __dmul_rn(z, z)));
      e.n += 1;
    }
  }
  // Maxima and minima are exact: any order of merging gives the same
  // extent (the count is lane 0's, a tree over the warp).
  for (int d = 16; d > 0; d >>= 1) merge(e, shfl_extent(e, d));
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) warps[warp] = e;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kKeyThreads / 32; ++w) merge(e, warps[w]);
    part = e;
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    Extent all;
    empty_extent(all);
    for (int r = 0; r < ctas; ++r) {
      merge(all, *cluster.map_shared_rank(&part, r));
    }
    double lo[3];
    double span = 0.0;
    double hi[3];
    for (int a = 0; a < 3; ++a) {
      lo[a] = all.n ? static_cast<double>(all.lo[a]) : 0.0;
      hi[a] = all.n ? static_cast<double>(all.hi[a]) : 0.0;
      span = a == 0 ? __dsub_rn(hi[a], lo[a])
                    : fmax(span, __dsub_rn(hi[a], lo[a]));
      cell[a] = lo[a];
    }
    // neighbors.cell_grid: cut = 2 max_r + 2 probe, thr = cut^2 + 1e-3,
    // h = max(sqrt((thr + D2_ERR (r2 + thr)) (1 + H_SLACK)),
    //         span / (CELL_MAX - 1)).
    const double cut =
        __dadd_rn(__dmul_rn(2.0, static_cast<double>(all.max_r)), two_probe);
    const double thr = __dadd_rn(__dmul_rn(cut, cut), 1e-3);
    const double edge = __dsqrt_rn(__dmul_rn(
        __dadd_rn(thr, __dmul_rn(kD2Err, __dadd_rn(all.r2, thr))), kHSlack));
    const double h =
        fmax(edge, __ddiv_rn(span, static_cast<double>(kCellMax - 1)));
    cell[3] = h;
    if (rank == 0) {
      max_r_out[s] = all.max_r;
      h_out[s] = h;
      int cells[3];
      for (int a = 0; a < 3; ++a) cells[a] = cell_of(hi[a], lo[a], h) + 1;
      grid_out[s] = make_int4(all.n, cells[0], cells[1], cells[2]);
    }
  }
  // Every CTA has read the others' partials (none may exit before), and
  // cell[] is set.
  cluster.sync();
  const double h = cell[3];
  for (int i0 = first + threadIdx.x; i0 < last;
       i0 += kKeyUnroll * kKeyThreads) {
    int g[kKeyUnroll];
    float4 cs[kKeyUnroll];
#pragma unroll
    for (int u = 0; u < kKeyUnroll; ++u) {
      const int i = i0 + u * kKeyThreads;
      g[u] = i < last ? __ldg(gid + base + i) : -1;
      cs[u] = i < last ? __ldg(packed + base + i)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kKeyUnroll; ++u) {
      const int i = i0 + u * kKeyThreads;
      if (i >= last) break;
      int64_t key = kPadKey;
      if (g[u] >= 0) {
        const float xyz[3] = {cs[u].x, cs[u].y, cs[u].z};
        key = static_cast<int64_t>(s) << kStructShift;
        for (int a = 0; a < 3; ++a) {
          key |= static_cast<int64_t>(cell_of(xyz[a], cell[a], h))
                 << ((2 - a) * kCellBits);
        }
      }
      keys[base + i] = key;
    }
  }
}

// ----------------------------------------------------------- cell_order

// A structure's dense cells (cell_keys_kernel's grid: real atoms, cells
// an axis) and a digit pass over them.
struct DenseCells {
  uint64_t ny, nz, pad;  // pad = nx ny nz, the padding slots' index
  int shift, mask;
  // The digit of the pass of the dense index of `key`.
  __device__ __forceinline__ int digit(int64_t key) const {
    const uint64_t d =
        key == kPadKey
            ? pad
            : (static_cast<uint64_t>((key >> (2 * kCellBits)) & kCellMax) *
                   ny +
               static_cast<uint64_t>((key >> kCellBits) & kCellMax)) *
                      nz +
                  static_cast<uint64_t>(key & kCellMax);
    return static_cast<int>(d >> shift) & mask;
  }
};

// Exclusive prefix sum of v over the CTA's threads (kKeyThreads);
// scratch holds kOrderWarps ints.  Every thread calls it.
__device__ __forceinline__ int cta_exclusive_sum(int v, int* scratch) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += scratch[w];
  __syncthreads();
  return before + incl - v;
}

// The sum over the CTA's threads of v, on every thread.
__device__ __forceinline__ int cta_sum(int v, int* scratch) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  int all = 0;
  for (int w = 0; w < kOrderWarps; ++w) all += scratch[w];
  __syncthreads();
  return all;
}

struct OrderOut {
  int64_t* sorted_keys;
  int64_t* perm;
  float4* sorted_packed;
  int* sorted_gid;
};

__global__ void __launch_bounds__(kKeyThreads)
cell_order_kernel(const int4* __restrict__ grid,  // [b] cell_keys_kernel's
                  const int64_t* __restrict__ keys,
                  const float4* __restrict__ packed,
                  const int* __restrict__ gid, int b, int n,
                  int64_t* tmp_keys,  // [2][b*n]
                  int* tmp_slots,     // [2][b*n]
                  OrderOut out) {
  __shared__ int bins[kOrderWarps][kBins + 1];  // kBins: lanes past the run
  __shared__ int cta_total[kBins];
  __shared__ int scratch[kOrderWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int s = blockIdx.x / ctas;
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  const int64_t m = static_cast<int64_t>(b) * n;
  const int64_t base = static_cast<int64_t>(s) * n;

  // The real atoms of the structures before this one and of all.
  int before = 0;
  int total = 0;
  for (int t = threadIdx.x; t < b; t += kKeyThreads) {
    const int c = __ldg(&grid[t].x);
    total += c;
    before += t < s ? c : 0;
  }
  const int64_t real_before = cta_sum(before, scratch);
  const int64_t real_all = cta_sum(total, scratch);
  const int4 g = __ldg(grid + s);
  const int real = g.x;
  DenseCells dc;
  dc.ny = static_cast<uint64_t>(g.z);
  dc.nz = static_cast<uint64_t>(g.w);
  dc.pad = static_cast<uint64_t>(g.y) * dc.ny * dc.nz;
  const int bits = 64 - __clzll(static_cast<long long>(dc.pad));
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  const int width = (bits + passes - 1) / passes;
  dc.mask = (1 << width) - 1;

  // This warp's run of slots, whole steps of 32, held kSteps steps at a
  // time in registers (the whole run when n <= 32,768).
  const int segments = ctas * kOrderWarps;
  const int run = ((n + segments - 1) / segments + 31) / 32 * 32;
  const int lo = (rank * kOrderWarps + warp) * run;
  const int hi = min(n, lo + run);
  const bool resident = run <= 32 * kSteps;
  int64_t key[kSteps];
  int slot[kSteps];

  for (int pass = 0; pass < passes; ++pass) {
    const bool last = pass == passes - 1;
    const int64_t* src_keys = tmp_keys + ((pass - 1) & 1) * m + base;
    const int* src_slots = tmp_slots + ((pass - 1) & 1) * m + base;
    int64_t* dst_keys = tmp_keys + (pass & 1) * m + base;
    int* dst_slots = tmp_slots + (pass & 1) * m + base;
    dc.shift = pass * width;
    // Steps c0, c0 + 32, ... of the run into key[], slot[], loads issued
    // together.
    auto load = [&](int c0) {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int e = c0 + 32 * j + lane;
        if (e >= hi) break;
        if (pass == 0) {
          key[j] = __ldg(keys + base + e);
          slot[j] = e;
        } else {
          key[j] = __ldcg(src_keys + e);
          slot[j] = __ldcg(src_slots + e);
        }
      }
    };

    for (int t = threadIdx.x; t < kOrderWarps * (kBins + 1);
         t += kKeyThreads) {
      (&bins[0][0])[t] = 0;
    }
    __syncthreads();
    // Each warp's digit counts over its run.
    for (int c0 = lo; c0 < hi; c0 += 32 * kSteps) {
      load(c0);
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        if (c0 + 32 * j >= hi) break;  // uniform over the warp
        const int digit = c0 + 32 * j + lane < hi ? dc.digit(key[j]) : kBins;
        const unsigned peers = __match_any_sync(kFull, digit);
        if (lane == __ffs(peers) - 1) bins[warp][digit] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
    // Bin t: its counts before each warp of the CTA, and the CTA's total.
    {
      const int t = threadIdx.x;
      int sum = 0;
      for (int w = 0; w < kOrderWarps; ++w) {
        const int c = bins[w][t];
        bins[w][t] = sum;
        sum += c;
      }
      cta_total[t] = sum;
    }
    cluster.sync();
    // Bin t's place: the structure's slots of lower digits, then its own
    // digit's in the CTAs before this one.
    {
      const int t = threadIdx.x;
      int all = 0;
      int earlier = 0;
      for (int r = 0; r < ctas; ++r) {
        const int c = cluster.map_shared_rank(cta_total, r)[t];
        all += c;
        earlier += r < rank ? c : 0;
      }
      const int place = cta_exclusive_sum(all, scratch) + earlier;
      for (int w = 0; w < kOrderWarps; ++w) bins[w][t] += place;
    }
    __syncthreads();
    // Each slot to its place, in order within its warp's run: the places
    // of a chunk's steps first, then their stores (and the last pass's
    // gathers), issued together.
    for (int c0 = lo; c0 < hi; c0 += 32 * kSteps) {
      if (!resident) load(c0);
      int at[kSteps];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        if (c0 + 32 * j >= hi) break;
        const int digit = c0 + 32 * j + lane < hi ? dc.digit(key[j]) : kBins;
        const unsigned peers = __match_any_sync(kFull, digit);
        at[j] = bins[warp][digit] + __popc(peers & below);
        __syncwarp();
        if (lane == __ffs(peers) - 1) bins[warp][digit] += __popc(peers);
        __syncwarp();
      }
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        if (c0 + 32 * j + lane >= hi) break;
        if (!last) {
          __stcg(dst_keys + at[j], key[j]);
          __stcg(dst_slots + at[j], slot[j]);
          continue;
        }
        // The batch's place: real atoms after those of the structures
        // before, padding after every real atom, in index order.
        const int64_t p = at[j] < real
                              ? real_before + at[j]
                              : real_all + (base - real_before) +
                                    (at[j] - real);
        const int64_t atom = base + slot[j];
        out.sorted_keys[p] = key[j];
        out.perm[p] = atom;
        out.sorted_packed[p] = __ldg(packed + atom);
        out.sorted_gid[p] = __ldg(gid + atom);
      }
    }
    // The pass's pairs are in place, and no CTA reads cta_total again.
    cluster.sync();
  }
}

// ----------------------------------------------------------- neighbor_cells

struct Inputs {
  const float4* packed;   // [m] x, y, z, r by atom (the rows)
  const int* gid;         // [m] by atom
  const int64_t* keys;    // [m] cell keys by atom
  const float* max_r;     // [b]
  const int64_t* sorted_keys;  // [m]
  const int64_t* perm;    // [m] sorted position -> atom
  const float4* spacked;  // [m] packed in sorted order
  const int* sgid;        // [m] gid in sorted order
  int m, n, k, m4;
  float probe, two_probe;
};

// Row i's own terms.
struct Row {
  float x, y, z;
  float sq;     // (x*x + y*y) + z*z
  float thr;    // cutoff*cutoff + 1e-3
  int gid;
};

__device__ __forceinline__ float sum3sq(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// d2 of row r and atom cj, and whether that atom is r's candidate.
__device__ __forceinline__ bool candidate(const Row& r, float4 cj, int gj,
                                          float& d2) {
  const float sqj = sum3sq(cj.x, cj.y, cj.z);
  const float cross =
      __fmaf_rn(r.z, cj.z, __fmaf_rn(r.y, cj.y, __fmul_rn(r.x, cj.x)));
  d2 = fmaxf(__fsub_rn(__fadd_rn(r.sq, sqj), __fmul_rn(2.0f, cross)), 0.0f);
  return gj != r.gid && d2 <= r.thr;
}

// The top_k order of a candidate: d2 (>= 0, so its bits order as
// integers), then the lower index.
__device__ __forceinline__ uint64_t order_key(float d2, int j) {
  return (static_cast<uint64_t>(__float_as_uint(d2)) << 32) |
         static_cast<uint32_t>(j);
}

// First p with keys[p] >= key (upper = false) or keys[p] > key (true).
// Each step loads kWays - 1 keys at once and keeps the one of kWays parts
// that holds the answer (a binary search's chain of dependent loads cut
// to half at kWays = 4), then binary steps finish.
__device__ __forceinline__ int search(const int64_t* keys, int m, int64_t key,
                                      bool upper) {
  int lo = 0;
  int hi = m;
  while (hi - lo >= kWays) {
    const int step = (hi - lo) / kWays;
    int before = 0;  // probes below the answer (a prefix of them)
#pragma unroll
    for (int w = 1; w < kWays; ++w) {
      const int64_t v = __ldg(keys + lo + w * step);
      before += v < key || (upper && v == key);
    }
    hi = before + 1 < kWays ? lo + (before + 1) * step : hi;
    lo = before > 0 ? lo + before * step + 1 : lo;
  }
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int64_t v = __ldg(keys + mid);
    if (v < key || (upper && v == key)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The nine column ranges of the cell of `key` in sorted positions, laid
// end to end in col[]: column c starts at sorted position col[c].x and
// visit position col[c].y; col[9].y is the atoms visited.
__device__ __forceinline__ void column_ranges(const Inputs& in, int64_t key,
                                              int lane, int2* col) {
  const int c = lane < kColumns ? lane : lane - kColumns;
  int bound = 0;
  if (lane < 2 * kColumns) {
    const int64_t base = (key >> kStructShift) << kStructShift;
    const int x = static_cast<int>((key >> (2 * kCellBits)) & kCellMax) +
                  c / 3 - 1;
    const int y = static_cast<int>((key >> kCellBits) & kCellMax) + c % 3 - 1;
    const int cz = static_cast<int>(key & kCellMax);
    if (x >= 0 && x <= kCellMax && y >= 0 && y <= kCellMax) {
      const int64_t column = base |
                             (static_cast<int64_t>(x) << (2 * kCellBits)) |
                             (static_cast<int64_t>(y) << kCellBits);
      bound = lane < kColumns
                  ? search(in.sorted_keys, in.m, column | (cz > 0 ? cz - 1 : 0),
                           false)
                  : search(in.sorted_keys, in.m,
                           column | (cz < kCellMax ? cz + 1 : kCellMax), true);
    }
  }
  // Lane c < 9: its column's end from lane c + 9, then the inclusive sum
  // of the lengths over lanes 0..c.
  const int end = __shfl_sync(kFull, bound, (lane + kColumns) & 31);
  const int len = lane < kColumns ? end - bound : 0;
  int incl = len;
  for (int d = 1; d < 16; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane < kColumns) col[lane] = make_int2(bound, incl - len);
  if (lane == kColumns - 1) col[kColumns] = make_int2(0, incl);
}

// The record of row atom ci against atom cj: v = c_i - c_j and the
// limit ((nr*nr - v2) - reff*reff) / (2*reff), nr = r_j + probe, reff =
// r_i + probe.
__device__ __forceinline__ float4 record(float4 ci, float4 cj, float probe) {
  const float vx = __fsub_rn(ci.x, cj.x);
  const float vy = __fsub_rn(ci.y, cj.y);
  const float vz = __fsub_rn(ci.z, cj.z);
  const float v2 = sum3sq(vx, vy, vz);
  const float nr = __fadd_rn(cj.w, probe);
  const float reff = __fadd_rn(ci.w, probe);
  const float lim =
      __fdiv_rn(__fsub_rn(__fsub_rn(__fmul_rn(nr, nr), v2),
                          __fmul_rn(reff, reff)),
                __fmul_rn(2.0f, reff));
  return make_float4(vx, vy, vz, lim);
}

// Walks the row's visited atoms in visit order, 32 a step (every lane
// calls step(ok, p, cj, d2) each step: ok = its atom is a candidate,
// false past the end; p its sorted position).  A lane's visit positions
// rise by 32 a step, so its column only moves on; the next step's atoms
// are loaded before this step's are tested.
template <class Step>
__device__ __forceinline__ void scan(const Inputs& in, const Row& r,
                                     const int2* col, int total, int lane,
                                     Step&& step) {
  int c = 0;
  auto load = [&](int pos, int& p, float4& cj, int& gj) {
    p = 0;
    cj = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    gj = r.gid;  // past the end: never a candidate
    if (pos < total) {
      while (pos >= col[c + 1].y) ++c;
      p = col[c].x + (pos - col[c].y);
      cj = __ldg(in.spacked + p);
      gj = __ldg(in.sgid + p);
    }
  };
  int p, gj;
  float4 cj;
  load(lane, p, cj, gj);
  for (int t = 0; t < total; t += 32) {
    int p_next, gj_next;
    float4 cj_next;
    load(t + 32 + lane, p_next, cj_next, gj_next);
    float d2;
    const bool ok = candidate(r, cj, gj, d2);
    step(ok, p, cj, d2);
    p = p_next;
    cj = cj_next;
    gj = gj_next;
  }
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
neighbor_cells_kernel(Inputs in, float* __restrict__ planes,
                      int* __restrict__ counts, int* __restrict__ max_count) {
  extern __shared__ int stage[];  // [ks][kRows] sorted positions
  __shared__ int row_count[kRows];
  __shared__ int2 cols[kRows][kColumns + 1];  // each row's column ranges
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  const int row0 = blockIdx.x * kRows;
  const int i = row0 + warp;
  const int k = in.k;
  const int ks = k < kStageCap ? k : kStageCap;
  const int64_t plane = static_cast<int64_t>(k) * in.m4;

  // A row's column ranges are its cell's: the first row of each run of
  // rows in one cell (its leader) searches them for the run.
  const bool real = i < in.m && __ldg(in.gid + i) >= 0;
  const int64_t key = real ? __ldg(in.keys + i) : kPadKey;
  const int other = row0 + lane;
  const unsigned same = __ballot_sync(
      kFull, lane < kRows && other < in.m && __ldg(in.keys + other) == key);
  const unsigned breaks = ~same & ((1u << warp) - 1u);
  const int leader = breaks ? 32 - __clz(breaks) : 0;
  if (real && leader == warp) column_ranges(in, key, lane, cols[warp]);
  __syncthreads();

  int count = 0;
  if (real) {
    const float4 ci = __ldg(in.packed + i);
    Row r;
    r.x = ci.x;
    r.y = ci.y;
    r.z = ci.z;
    r.gid = __ldg(in.gid + i);
    r.sq = sum3sq(ci.x, ci.y, ci.z);
    const float cut =
        __fadd_rn(__fadd_rn(ci.w, __ldg(in.max_r + i / in.n)), in.two_probe);
    r.thr = __fadd_rn(__fmul_rn(cut, cut), kCutoffSlack);
    const int2* col = cols[leader];
    const int total = col[kColumns].y;

    // Candidate cj at sorted position p keeps `slot`: its position is
    // staged below ks (the record is made at the write-out), its record
    // stored straight to device memory from ks on.
    auto put = [&](int slot, int p, float4 cj) {
      if (slot < ks) {
        stage[slot * kRows + warp] = p;
      } else {
        const float4 v = record(ci, cj, in.probe);
        float* at = planes + static_cast<int64_t>(slot) * in.m4 + i;
        at[0] = v.x;
        at[plane] = v.y;
        at[2 * plane] = v.z;
        at[3 * plane] = v.w;
      }
    };

    scan(in, r, col, total, lane, [&](bool ok, int p, float4 cj, float) {
      const unsigned vote = __ballot_sync(kFull, ok);
      if (ok) {
        const int slot = count + __popc(vote & below);
        if (slot < k) put(slot, p, cj);
      }
      count += __popc(vote);
    });
    if (count > k) {
      // The k-th smallest order key: the largest t with fewer than k
      // candidates' keys below t, bit by bit from the top.
      uint64_t kth = 0;
      for (int bit = 62; bit >= 0; --bit) {
        const uint64_t trial = kth | (1ull << bit);
        int n_below = 0;
        scan(in, r, col, total, lane, [&](bool ok, int p, float4, float d2) {
          n_below += __popc(__ballot_sync(
              kFull, ok && order_key(d2, static_cast<int>(__ldg(in.perm + p))) <
                               trial));
        });
        if (n_below < k) kth = trial;
      }
      int slot = 0;
      scan(in, r, col, total, lane, [&](bool ok, int p, float4 cj, float d2) {
        const bool keep =
            ok && order_key(d2, static_cast<int>(__ldg(in.perm + p))) <= kth;
        const unsigned vote = __ballot_sync(kFull, keep);
        if (keep) put(slot + __popc(vote & below), p, cj);
        slot += __popc(vote);
      });
    }
    if (lane == 0) counts[i] = count;
  } else if (i < in.m && lane == 0) {
    counts[i] = 0;
  }
  if (lane == 0) row_count[warp] = count;
  __syncthreads();

  // The CTA's largest count, one atomic a CTA.
  if (warp == 0) {
    int most = lane < kRows ? row_count[lane] : 0;
    for (int d = 16; d > 0; d >>= 1) {
      most = max(most, __shfl_down_sync(kFull, most, d));
    }
    if (lane == 0 && most > 0) atomicMax(max_count, most);
  }

  // A thread a (slot, 4 rows): the rows' records below their kept counts
  // (made here from the staged positions), (0, 0, 0, -1e30) past them,
  // each plane's four as one 16-byte store, so a plane's slot is kRows
  // consecutive floats.  Slots at or past ks that a row kept went to
  // device memory from the row's warp; only the fill is written here.
  constexpr int kQuads = kRows / 4;
  const int items = k * kQuads;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int q = it % kQuads;
    const int slot = it / kQuads;
    const int c0 = row0 + 4 * q;
    if (c0 >= in.m4) continue;
    float4 v[4];  // by row: vx, vy, vz, limit
    bool mine[4];  // the slot is this thread's to write for the row
    bool all = true;
    for (int t = 0; t < 4; ++t) {
      const bool kept = slot < min(row_count[4 * q + t], k);
      mine[t] = !kept || slot < ks;
      all = all && mine[t];
      v[t] = make_float4(0.0f, 0.0f, 0.0f, kNegBig);
      if (kept && slot < ks) {
        v[t] = record(__ldg(in.packed + c0 + t),
                      __ldg(in.spacked + stage[slot * kRows + 4 * q + t]),
                      in.probe);
      }
    }
    float* dst = planes + static_cast<int64_t>(slot) * in.m4 + c0;
    if (all) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
      *reinterpret_cast<float4*>(dst + plane) =
          make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
      *reinterpret_cast<float4*>(dst + 2 * plane) =
          make_float4(v[0].z, v[1].z, v[2].z, v[3].z);
      *reinterpret_cast<float4*>(dst + 3 * plane) =
          make_float4(v[0].w, v[1].w, v[2].w, v[3].w);
    } else {
      for (int t = 0; t < 4; ++t) {
        if (!mine[t]) continue;
        dst[t] = v[t].x;
        dst[plane + t] = v[t].y;
        dst[2 * plane + t] = v[t].z;
        dst[3 * plane + t] = v[t].w;
      }
    }
  }
}

}  // namespace

// Launches cell_keys on `stream` without synchronizing: the binning
// kernel, then the ordering kernel.  packed f32 [b*n, 4] (16-byte
// aligned), gid i32 [b*n]; writes keys i64 [b*n], max_r f32 [b], h f64
// [b], sorted_keys and perm i64 [b*n] (the keys' stable sort), and
// packed and gid at perm, sorted_packed f32 [b*n, 4] (16-byte aligned)
// and sorted_gid i32 [b*n]; grid i32 [b, 4] (16-byte aligned) and
// tmp_keys i64 [2, b*n], tmp_slots i32 [2, b*n] are scratch.  1 <= b <=
// 511, n >= 1, b*n < 2^31.  Returns the cudaError_t of the launches.
extern "C" int cell_keys_launch(const void* packed, const void* gid,
                                void* keys, void* max_r, void* h,
                                void* sorted_keys, void* perm,
                                void* sorted_packed, void* sorted_gid,
                                void* grid, void* tmp_keys, void* tmp_slots,
                                int b, int n, double two_probe,
                                void* stream) {
  if (b < 1 || b > kMaxBatch || n < 1 ||
      static_cast<int64_t>(b) * n >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ctas = cluster_ctas(n);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ctas;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(b * ctas);
  config.blockDim = dim3(kKeyThreads);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &cluster;
  config.numAttrs = 1;
  cudaError_t rc = cudaLaunchKernelEx(
      &config, cell_keys_kernel, static_cast<const float4*>(packed),
      static_cast<const int*>(gid), n, two_probe,
      static_cast<int64_t*>(keys), static_cast<float*>(max_r),
      static_cast<double*>(h), static_cast<int4*>(grid));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaLaunchKernelEx(
      &config, cell_order_kernel, static_cast<const int4*>(grid),
      static_cast<const int64_t*>(keys), static_cast<const float4*>(packed),
      static_cast<const int*>(gid), b, n, static_cast<int64_t*>(tmp_keys),
      static_cast<int*>(tmp_slots),
      OrderOut{static_cast<int64_t*>(sorted_keys),
               static_cast<int64_t*>(perm),
               static_cast<float4*>(sorted_packed),
               static_cast<int*>(sorted_gid)});
  return static_cast<int>(rc);
}

// Launches neighbor_cells on `stream` without synchronizing.  packed and
// sorted_packed f32 [b*n, 4] (16-byte aligned), gid and sorted_gid i32
// [b*n], keys, sorted_keys and perm i64 [b*n] (sorted_packed[p] =
// packed[perm[p]]), max_r f32 [b]; writes planes f32 [4][k][m4], counts
// i32 [b*n] and max_count i32 [1] (zeroed first).  1 <= b <= 511, n >= 1,
// 1 <= k <= n, m4 = b*n rounded up to 4 (under 2^31).  Returns the
// cudaError_t of the launch.
extern "C" int neighbor_cells_launch(
    const void* packed, const void* gid, const void* keys, const void* max_r,
    const void* sorted_keys, const void* perm, const void* sorted_packed,
    const void* sorted_gid, void* planes, void* counts, void* max_count,
    int b, int n, int k, int m4, float probe, float two_probe, void* stream) {
  const int64_t m = static_cast<int64_t>(b) * n;
  if (b < 1 || b > kMaxBatch || n < 1 || k < 1 || k > n || m4 < m ||
      m4 % 4 || m4 - m >= 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(max_count, 0, sizeof(int), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const Inputs in{static_cast<const float4*>(packed),
                  static_cast<const int*>(gid),
                  static_cast<const int64_t*>(keys),
                  static_cast<const float*>(max_r),
                  static_cast<const int64_t*>(sorted_keys),
                  static_cast<const int64_t*>(perm),
                  static_cast<const float4*>(sorted_packed),
                  static_cast<const int*>(sorted_gid),
                  static_cast<int>(m),
                  n,
                  k,
                  m4,
                  probe,
                  two_probe};
  const int ks = k < kStageCap ? k : kStageCap;
  const size_t smem = sizeof(int) * ks * kRows;
  neighbor_cells_kernel<<<(m4 + kRows - 1) / kRows, kThreads, smem, s>>>(
      in, static_cast<float*>(planes), static_cast<int*>(counts),
      static_cast<int*>(max_count));
  return static_cast<int>(cudaGetLastError());
}
