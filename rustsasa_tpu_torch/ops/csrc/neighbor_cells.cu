// Neighbor phase of the list path for NVIDIA Hopper (sm_90a), plain C
// interface: a cell list that writes the occlusion kernel's K-major
// records.
//
// Replaces the XLA device code of the JAX package's list path,
// rustsasa_tpu/ops/engine.py:138-211 (_neighbor_phase: a full-FP32
// [rows, N] d^2 expansion, a cutoff mask, lax.top_k of the K nearest and
// a gather of v and the limits), for a whole [B, N] batch in one launch.
//
// Inputs (ops/neighbors.py, neighbor_records): packed [B*N] float4 (x,
// y, z, r), gid [B*N] (-1 = padding), each structure's largest real
// radius max_r [B], each atom's cell key (structure << 54 | cell x << 36
// | cell y << 18 | cell z; padding INT64_MAX) and the keys sorted stably
// with their permutation (neighbors.cell_grid and torch.sort: sorting is
// bookkeeping the reference's arithmetic has no counterpart for).
// Outputs: the vx, vy, vz and limit planes [K][m4] (K-major, m4 = B*N
// rounded up to 4) and counts [B*N].
//
// One thread a row i (an atom slot, in index order, so that a warp's
// atoms lie near each other in a protein and share their cells in L1).
// It visits the 27 cells around its own in a fixed order - for dx, then
// dy in -1..1, the column of cells z-1..z+1, found by one binary search
// for its first key, each cell's atoms in index order (the sort is
// stable) - and tests each j as the plain version does:
//   sq = (x*x + y*y) + z*z,  cross = fma(z_i, z_j, fma(y_i, y_j, x_i*x_j)),
//   d2 = max((sq_i + sq_j) - 2*cross, 0),  cutoff = (r_i + max_r) + 2 probe,
//   candidate iff gid_i != gid_j and d2 <= cutoff*cutoff + 1e-3
// (j's key says it is real and of i's structure).  A candidate's record:
// v = c_i - c_j, v2 = (vx*vx + vy*vy) + vz*vz, nr = r_j + probe, reff =
// r_i + probe, limit = ((nr*nr - v2) - reff*reff) / (2*reff).  Every
// operation is an explicitly rounded intrinsic in that order (the library
// is also built with --fmad=false); the cross term is the one fused chain
// that the reference's HIGHEST dot (and the plain version's fma.dot3)
// computes.  So the records equal the plain version's bit for bit.
//
// counts[i] is the number of candidates.  When it is <= K the row's
// records are its candidates in visit order and the remaining slots (0,
// 0, 0, -1e30).  When it is > K the row keeps the K nearest, as top_k
// keeps them: the K smallest (d2 bits, j) keys (ties to the lower index),
// found by a bitwise search over the key's 63 bits that rescans the cells
// once a bit - a slow path for rows whose batch the caller re-runs with a
// larger K.  Padding rows and the columns past B*N get count 0 and K
// records that never occlude.
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
// edge h of neighbors.cell_grid (D2_ERR = 32 u, H_SLACK = 2^-20).  Each
// axis of c_i - c_j is then under h (1 - 2^-22); with the cells computed
// in f64 (relative error ~1e-16, at most 2^18 cells an axis) the two
// atoms' cells differ by at most one on every axis.  The bound grows with
// R^2 - ~0.02 A^2 at |c| ~ 100 A, ~3 A^2 at 1,300 A - and h with it: the
// list path sets no limit on a structure's extent.
//
// Bound: bytes.  The records are K x m4 x 16 bytes (84 MB for 1jz8 at K =
// 160) against ~12 FP32 instructions a visited pair and ~15 more a
// candidate (hundreds of pairs an atom).  This first kernel stores each
// record from its own thread; a warp's stores of one slot are one row of
// the plane where its rows' counts agree.  Staging the rows through
// shared memory for whole-line stores is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCellBits = 18;
constexpr int kCellMax = (1 << kCellBits) - 1;
constexpr int kStructShift = 3 * kCellBits;
constexpr int kMaxBatch = 511;  // _kernels.MAX_CELL_BATCH
constexpr float kNegBig = -1e30f;
constexpr float kCutoffSlack = 1e-3f;

struct Inputs {
  const float4* packed;  // [m] x, y, z, r
  const int* gid;        // [m]
  const int64_t* sorted_keys;
  const int64_t* perm;
  int m;
};

// Row i's own terms.
struct Row {
  float x, y, z;
  float sq;     // (x*x + y*y) + z*z
  float thr;    // cutoff*cutoff + 1e-3
  float reff2;  // reff*reff
  float den;    // 2*reff
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

__device__ __forceinline__ void store(float* planes, int64_t plane,
                                      int64_t at, float vx, float vy,
                                      float vz, float lim) {
  planes[at] = vx;
  planes[plane + at] = vy;
  planes[2 * plane + at] = vz;
  planes[3 * plane + at] = lim;
}

__device__ __forceinline__ void store_record(float* planes, int64_t plane,
                                             int64_t at, const Row& r,
                                             float4 cj, float probe) {
  const float vx = __fsub_rn(r.x, cj.x);
  const float vy = __fsub_rn(r.y, cj.y);
  const float vz = __fsub_rn(r.z, cj.z);
  const float v2 = sum3sq(vx, vy, vz);
  const float nr = __fadd_rn(cj.w, probe);
  const float lim = __fdiv_rn(
      __fsub_rn(__fsub_rn(__fmul_rn(nr, nr), v2), r.reff2), r.den);
  store(planes, plane, at, vx, vy, vz, lim);
}

// First index p of the sorted keys with keys[p] >= key.
__device__ __forceinline__ int lower_bound(const int64_t* keys, int m,
                                           int64_t key) {
  int lo = 0;
  int hi = m;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Calls visit(j) for every real atom j of the 27 cells around the cell of
// `key`, in the fixed order above (row i itself included).
template <class Visit>
__device__ __forceinline__ void visit_cells(const Inputs& in, int64_t key,
                                            Visit&& visit) {
  const int64_t base = (key >> kStructShift) << kStructShift;
  const int cx = static_cast<int>((key >> (2 * kCellBits)) & kCellMax);
  const int cy = static_cast<int>((key >> kCellBits) & kCellMax);
  const int cz = static_cast<int>(key & kCellMax);
  const int64_t z0 = cz > 0 ? cz - 1 : 0;
  const int64_t z1 = cz < kCellMax ? cz + 1 : kCellMax;
  for (int dx = -1; dx <= 1; ++dx) {
    const int x = cx + dx;
    if (x < 0 || x > kCellMax) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int y = cy + dy;
      if (y < 0 || y > kCellMax) continue;
      const int64_t column = base |
                             (static_cast<int64_t>(x) << (2 * kCellBits)) |
                             (static_cast<int64_t>(y) << kCellBits);
      const int64_t last = column | z1;
      for (int p = lower_bound(in.sorted_keys, in.m, column | z0);
           p < in.m && __ldg(in.sorted_keys + p) <= last; ++p) {
        visit(static_cast<int>(__ldg(in.perm + p)));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
neighbor_cells_kernel(Inputs in, const float* __restrict__ max_r,
                      const int64_t* __restrict__ keys,
                      float* __restrict__ planes, int* __restrict__ counts,
                      int n, int k, int m4, float probe, float two_probe) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m4) return;
  const int64_t plane = static_cast<int64_t>(k) * m4;
  int kept = 0;
  if (i < in.m && in.gid[i] >= 0) {
    const float4 ci = __ldg(in.packed + i);
    Row r;
    r.x = ci.x;
    r.y = ci.y;
    r.z = ci.z;
    r.gid = in.gid[i];
    r.sq = sum3sq(ci.x, ci.y, ci.z);
    const float cut = __fadd_rn(__fadd_rn(ci.w, max_r[i / n]), two_probe);
    r.thr = __fadd_rn(__fmul_rn(cut, cut), kCutoffSlack);
    const float reff = __fadd_rn(ci.w, probe);
    r.reff2 = __fmul_rn(reff, reff);
    r.den = __fmul_rn(2.0f, reff);
    const int64_t key = keys[i];

    int count = 0;
    visit_cells(in, key, [&](int j) {
      const float4 cj = __ldg(in.packed + j);
      float d2;
      if (candidate(r, cj, __ldg(in.gid + j), d2)) {
        if (count < k) {
          store_record(planes, plane, static_cast<int64_t>(count) * m4 + i,
                       r, cj, probe);
        }
        ++count;
      }
    });
    if (count > k) {
      // The k-th smallest order key: the largest t with fewer than k
      // candidates' keys below t, bit by bit from the top.
      uint64_t kth = 0;
      for (int bit = 62; bit >= 0; --bit) {
        const uint64_t trial = kth | (1ull << bit);
        int below = 0;
        visit_cells(in, key, [&](int j) {
          float d2;
          if (candidate(r, __ldg(in.packed + j), __ldg(in.gid + j), d2) &&
              order_key(d2, j) < trial) {
            ++below;
          }
        });
        if (below < k) kth = trial;
      }
      int slot = 0;
      visit_cells(in, key, [&](int j) {
        const float4 cj = __ldg(in.packed + j);
        float d2;
        if (candidate(r, cj, __ldg(in.gid + j), d2) &&
            order_key(d2, j) <= kth) {
          store_record(planes, plane, static_cast<int64_t>(slot) * m4 + i,
                       r, cj, probe);
          ++slot;
        }
      });
    }
    counts[i] = count;
    kept = count < k ? count : k;
  } else if (i < in.m) {
    counts[i] = 0;
  }
  for (int s = kept; s < k; ++s) {
    store(planes, plane, static_cast<int64_t>(s) * m4 + i, 0.0f, 0.0f, 0.0f,
          kNegBig);
  }
}

}  // namespace

// Launches neighbor_cells on `stream` without synchronizing.  packed f32
// [b*n, 4] (16-byte aligned), gid i32 [b*n], max_r f32 [b], keys,
// sorted_keys and perm i64 [b*n]; writes planes f32 [4][k][m4] and counts
// i32 [b*n].  1 <= b <= 511, n >= 1, 1 <= k <= n, m4 = b*n rounded up to
// 4 (under 2^31).  Returns the cudaError_t of the launch.
extern "C" int neighbor_cells_launch(const void* packed, const void* gid,
                                     const void* max_r, const void* keys,
                                     const void* sorted_keys,
                                     const void* perm, void* planes,
                                     void* counts, int b, int n, int k,
                                     int m4, float probe, float two_probe,
                                     void* stream) {
  const int64_t m = static_cast<int64_t>(b) * n;
  if (b < 1 || b > kMaxBatch || n < 1 || k < 1 || k > n || m4 < m ||
      m4 % 4 || m4 - m >= 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Inputs in{static_cast<const float4*>(packed),
                  static_cast<const int*>(gid),
                  static_cast<const int64_t*>(sorted_keys),
                  static_cast<const int64_t*>(perm), static_cast<int>(m)};
  neighbor_cells_kernel<<<(m4 + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float*>(max_r),
      static_cast<const int64_t*>(keys), static_cast<float*>(planes),
      static_cast<int*>(counts), n, k, m4, probe, two_probe);
  return static_cast<int>(cudaGetLastError());
}
