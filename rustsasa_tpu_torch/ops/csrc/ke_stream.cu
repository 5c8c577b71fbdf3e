// The f32 margin stream of the kernel experiments, for NVIDIA Hopper
// (sm_90a), plain C interface.
//
// Replaces three Pallas TPU kernels of scripts/kernel_experiments.py:
// `make_kernel(variant)` (:29; full, noscalar, nogid, nobig),
// `make_grouped_kernel(group=8, smem)` (:116; group8, group8_smem) and
// `make_v2_kernel(fma, skip, hoist)` (:213; g8, g8_fma, g8_fma_skip,
// g8_hoist, g8_hoist_skip).  Per i-atom of the CTA's tile, the sum over
// the 128 points of
//     max_j lim_ij - (s_x*vx + (s_y*vy + s_z*vz)),  v = c_i - c_j,
// (g8_fma: ((lim - s_x*vx) - s_y*vy) - s_z*vz; nobig: max_j lim_ij) over
// nj resident j-rows.  The variants differ where the script's do:
//   * rows: make_kernel reads each j-row as it goes (two broadcast
//     LDS.128 per row); group8 and the g8 family load a group's 8 rows
//     into registers first; group8_smem reads row by row within groups;
//   * the sphere: re-read from shared memory for every row (each point a
//     broadcast LDS.128), or held in registers for the whole loop (hoist);
//   * skip: an 8-row group runs only if the CTA's reach vote says some
//     (row, atom) pair of it has v2 < (r_i + r_j)^2.
// Every operation is a separately rounded __f*_rn intrinsic in the
// script's order, so each variant equals its plain version bit for bit.
//
// Bound: FP32 issue, 7 instructions per margin.  Layout: 256 threads,
// each 16 points x 4 atoms (a warp shares its points, so the sphere reads
// are broadcasts); per j-row each thread first computes v and the limit
// of its 4 atoms (about 14 instructions per atom, 1/8 of the margin
// work), then 64 margins.
//
// Two variants do less work than their loop form, and run kernels of
// their own that do only what the function needs:
//   * nobig's margin is the limit, which does not depend on the point, so
//     every point's maximum is M_a = max(-1e30, max_j lim_aj) and the sum
//     is 128 in-order copies of it.  fmaxf is exact and order-free on
//     these non-NaN values, so M_a may be folded in any split of the
//     rows.  Bound: the limit chain and one max per (atom, j-row) pair
//     (kernel_experiments.NOBIG_INSTR_PER_PAIR).  One CTA per i-tile,
//     256 threads = 4 atoms x 32 lanes x 8 warps; warp w folds the j-rows
//     of slice w of 8, read as warp-uniform broadcasts (x, y, z, r*r as
//     one LDS.128 and the gid) from the j-data staged once per CTA; the
//     slices' maxima meet in shared memory and one thread per atom adds
//     its M_a 128 times in order.  No [128][128] maxima are staged.
//   * noscalar's j-row is the script's constants (1, 2, 3, r*r = 3.1*3.1
//     rounded to f32, gid 7), the same for every row, and
//     fmaxf(fmaxf(x, m), m) == fmaxf(x, m): the result is that one row's
//     128 x 128 margins, max(-1e30, lim - dots), summed in order.  One
//     thread per atom; launch-bound.
// Both write executed = nj / 8, as the plain versions report.

#include "ke_common.cuh"

namespace {

using namespace ke;

enum Rows { kPerRow = 0, kGroupRegs = 1, kGroupSmem = 2 };

// One j-row (xk, yk, zk, rr = rk*rk, gk) against a thread's 16 x 4
// margins: v and the limit of its atoms, then the margins.
template <bool kGid, bool kFma, bool kHoist>
__device__ __forceinline__ void stream_row(const IAtom (&at)[kAts],
                                           float (&occ)[kPts][kAts],
                                           const float4 (&sreg)[kPts],
                                           const float4* sph, float xk,
                                           float yk, float zk, float rr,
                                           float gk) {
  float lim[kAts], vx[kAts], vy[kAts], vz[kAts];
#pragma unroll
  for (int k = 0; k < kAts; ++k) {
    float v2;
    lim[k] = limit<kGid>(at[k], xk, yk, zk, rr, gk, vx[k], vy[k], vz[k], v2);
  }
#pragma unroll
  for (int q = 0; q < kPts; ++q) {
    const float4 sp = kHoist ? sreg[q] : sph[q];
#pragma unroll
    for (int k = 0; k < kAts; ++k) {
      float mg;
      if (kFma) {
        mg = __fsub_rn(lim[k], __fmul_rn(sp.x, vx[k]));
        mg = __fsub_rn(mg, __fmul_rn(sp.y, vy[k]));
        mg = __fsub_rn(mg, __fmul_rn(sp.z, vz[k]));
      } else {
        mg = __fsub_rn(lim[k], __fadd_rn(__fmul_rn(sp.x, vx[k]),
                                         __fadd_rn(__fmul_rn(sp.y, vy[k]),
                                                   __fmul_rn(sp.z, vz[k]))));
      }
      occ[q][k] = fmaxf(occ[q][k], mg);
    }
  }
}

// kVariant only names the instantiation: variants with the same
// arithmetic and loop (group8, g8) still run as kernels of their own.
template <int kVariant, bool kGid, bool kFma, bool kSkip, bool kHoist,
          int kRows>
__global__ void __launch_bounds__(kThreads, 1)
ke_stream_kernel(const float4* __restrict__ sphere,
                 const float* __restrict__ planes,
                 const float* __restrict__ jdata, float* __restrict__ out,
                 int32_t* __restrict__ executed, int m, int nj) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(smem_raw, nj);
  stage_inputs(s, sphere, planes, jdata, m, nj);

  const int tid = threadIdx.x;
  const int a0 = (tid % 32) * kAts;
  const int p0 = (tid / 32) * kPts;
  IAtom at[kAts];
#pragma unroll
  for (int k = 0; k < kAts; ++k) at[k] = i_atom(s.irec, a0 + k);
  float occ[kPts][kAts];
#pragma unroll
  for (int q = 0; q < kPts; ++q)
#pragma unroll
    for (int k = 0; k < kAts; ++k) occ[q][k] = kNegBig;
  float4 sreg[kPts];
#pragma unroll
  for (int q = 0; q < kPts; ++q) {
    sreg[q] = kHoist ? s.sph[p0 + q] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* sph = s.sph + p0;
#define KE_ROW(xk, yk, zk, rr, gk) \
  stream_row<kGid, kFma, kHoist>(at, occ, sreg, sph, xk, yk, zk, rr, gk)

  int groups_run = 0;
  if (kRows == kPerRow) {
    for (int j = 0; j < nj; ++j) {
      const float4 r = *reinterpret_cast<const float4*>(s.jd + j * kJCols);
      const float gk = s.jd[j * kJCols + 4];
      KE_ROW(r.x, r.y, r.z, __fmul_rn(r.w, r.w), gk);
    }
    groups_run = nj / kGroup;
  } else {
    for (int g = 0; g < nj / kGroup; ++g) {
      const float* rows = s.jd + g * kGroup * kJCols;
      if (kSkip && !group_vote(s.irec, rows)) continue;
      ++groups_run;
      if (kRows == kGroupRegs) {
        float4 lo[kGroup];
        float gk[kGroup];
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          lo[r] = *reinterpret_cast<const float4*>(rows + r * kJCols);
          gk[r] = rows[r * kJCols + 4];
        }
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          KE_ROW(lo[r].x, lo[r].y, lo[r].z, __fmul_rn(lo[r].w, lo[r].w),
                 gk[r]);
        }
      } else {
#pragma unroll 1
        for (int r = 0; r < kGroup; ++r) {
          const float* jr = rows + r * kJCols;
          KE_ROW(jr[0], jr[1], jr[2], __fmul_rn(jr[3], jr[3]), jr[4]);
        }
      }
    }
  }
#undef KE_ROW
  stage_occ(s, occ, p0, a0);
  finish(s, out, executed, groups_run);
}

template <int kVariant, bool kGid, bool kFma, bool kSkip, bool kHoist,
          int kRows>
int launch(const float4* sphere, const float* planes, const float* jdata,
           float* out, int32_t* executed, int m, int nj, cudaStream_t stream) {
  return launch_tiles(
      ke_stream_kernel<kVariant, kGid, kFma, kSkip, kHoist, kRows>,
      base_smem(nj), m, stream, sphere, planes, jdata, out, executed, m, nj);
}

// j-slices of a nobig CTA: one per warp.
constexpr int kNobigSlices = kThreads / 32;

// Atom i's record from the planes, as stage_inputs computes it.
__device__ __forceinline__ IAtom plane_atom(const float* __restrict__ planes,
                                            int64_t m, int64_t i) {
  const float r = planes[3 * m + i];
  return IAtom{planes[i], planes[m + i], planes[2 * m + i], r,
               planes[4 * m + i], __fmul_rn(r, r),
               __fdiv_rn(0.5f, fmaxf(r, 1e-6f))};
}

// 128 in-order copies of v: the plain version's point sum of a maximum
// that every point shares.
__device__ __forceinline__ float point_sum_of(float v) {
  float acc = v;
  for (int p = 1; p < kP; ++p) acc = __fadd_rn(acc, v);
  return acc;
}

__global__ void __launch_bounds__(kThreads, 4)
ke_nobig_kernel(const float* __restrict__ planes,
                const float* __restrict__ jdata, float* __restrict__ out,
                int32_t* __restrict__ executed, int m, int nj) {
  extern __shared__ float4 smem_raw[];
  float4* rows = smem_raw;                                // [nj] x, y, z, r*r
  float* gids = reinterpret_cast<float*>(rows + nj);      // [nj]
  float* red = gids + nj;                                 // [slices][kA]

  const int tid = threadIdx.x;
  const int slice = tid / 32;  // the warp's j-slice
  const int lane = tid % 32;
  for (int j = tid; j < nj; j += kThreads) {
    const float4 r = *reinterpret_cast<const float4*>(jdata + j * kJCols);
    rows[j] = make_float4(r.x, r.y, r.z, __fmul_rn(r.w, r.w));
    gids[j] = jdata[j * kJCols + 4];
  }
  IAtom at[kAts];
  float mx[kAts];
#pragma unroll
  for (int k = 0; k < kAts; ++k) {
    at[k] = plane_atom(planes, m,
                       static_cast<int64_t>(blockIdx.x) * kA + lane * kAts + k);
    mx[k] = kNegBig;
  }
  __syncthreads();
  const int per = nj / kNobigSlices;
  const int j1 = (slice + 1) * per;
#pragma unroll 4
  for (int j = slice * per; j < j1; ++j) {
    const float4 r = rows[j];
    const float gk = gids[j];
#pragma unroll
    for (int k = 0; k < kAts; ++k) {
      float vx, vy, vz, v2;
      mx[k] = fmaxf(mx[k], limit<true>(at[k], r.x, r.y, r.z, r.w, gk, vx, vy,
                                       vz, v2));
    }
  }
  *reinterpret_cast<float4*>(red + slice * kA + lane * kAts) =
      make_float4(mx[0], mx[1], mx[2], mx[3]);
  __syncthreads();
  if (tid < kA) {
    float v = red[tid];
    for (int sl = 1; sl < kNobigSlices; ++sl) v = fmaxf(v, red[sl * kA + tid]);
    out[static_cast<int64_t>(blockIdx.x) * kA + tid] = point_sum_of(v);
  }
  if (tid == 0) executed[blockIdx.x] = nj / kGroup;
}

__global__ void __launch_bounds__(kA)
ke_noscalar_kernel(const float4* __restrict__ sphere,
                   const float* __restrict__ planes, float* __restrict__ out,
                   int32_t* __restrict__ executed, int m, int nj) {
  __shared__ float4 sph[kP];
  static_assert(kP == kA, "one thread per atom stages one point");
  const int a = threadIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kA + a;
  sph[a] = sphere[a];
  const IAtom at = plane_atom(planes, m, i);
  __syncthreads();
  float vx, vy, vz, v2;
  // The script's Python constants; 3.1 * 3.1 rounds to 9.61f.
  const float lim = limit<true>(at, 1.0f, 2.0f, 3.0f, 9.61f, 7.0f, vx, vy,
                                vz, v2);
  float acc = 0.0f;
  for (int p = 0; p < kP; ++p) {
    const float4 s = sph[p];
    const float occ = fmaxf(
        kNegBig,
        __fsub_rn(lim, __fadd_rn(__fmul_rn(s.x, vx),
                                 __fadd_rn(__fmul_rn(s.y, vy),
                                           __fmul_rn(s.z, vz)))));
    acc = p == 0 ? occ : __fadd_rn(acc, occ);
  }
  out[i] = acc;
  if (a == 0) executed[blockIdx.x] = nj / kGroup;
}

int launch_nobig(const float* planes, const float* jdata, float* out,
                 int32_t* executed, int m, int nj, cudaStream_t stream) {
  const size_t smem = sizeof(float4) * nj + sizeof(float) * nj +
                      sizeof(float) * kThreads / 32 * kA;
  const cudaError_t set = cudaFuncSetAttribute(
      ke_nobig_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  ke_nobig_kernel<<<m / kA, kThreads, smem, stream>>>(planes, jdata, out,
                                                      executed, m, nj);
  return static_cast<int>(cudaGetLastError());
}

int launch_noscalar(const float4* sphere, const float* planes, float* out,
                    int32_t* executed, int m, int nj, cudaStream_t stream) {
  ke_noscalar_kernel<<<m / kA, kA, 0, stream>>>(sphere, planes, out,
                                                 executed, m, nj);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches variant `variant` (0 full, 1 noscalar, 2 nogid, 3 nobig,
// 4 group8, 5 group8_smem, 6 g8, 7 g8_fma, 8 g8_fma_skip, 9 g8_hoist,
// 10 g8_hoist_skip) on `stream` without synchronizing.  sphere: f32
// [128, 4]; planes: f32 [8, m] (rows x, y, z, r_eff, gid); jdata: f32
// [nj, 8] (x, y, z, r, gid); out: f32 [m]; executed: i32 [m / 128].  m is
// a positive multiple of 128, nj a positive multiple of 8 up to 2048.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ke_stream_launch(const void* sphere, const void* planes,
                                const void* jdata, void* out, void* executed,
                                int m, int nj, int variant, void* stream) {
  if (!valid_shape(m, nj, kGroup)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* sp = static_cast<const float4*>(sphere);
  const auto* pl = static_cast<const float*>(planes);
  const auto* jd = static_cast<const float*>(jdata);
  auto* o = static_cast<float*>(out);
  auto* ex = static_cast<int32_t*>(executed);
  auto st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<0, true, false, false, false, kPerRow>(sp, pl, jd, o, ex, m, nj, st);
    case 1: return launch_noscalar(sp, pl, o, ex, m, nj, st);
    case 2: return launch<2, false, false, false, false, kPerRow>(sp, pl, jd, o, ex, m, nj, st);
    case 3: return launch_nobig(pl, jd, o, ex, m, nj, st);
    case 4: return launch<4, true, false, false, false, kGroupRegs>(sp, pl, jd, o, ex, m, nj, st);
    case 5: return launch<5, true, false, false, false, kGroupSmem>(sp, pl, jd, o, ex, m, nj, st);
    case 6: return launch<6, true, false, false, false, kGroupRegs>(sp, pl, jd, o, ex, m, nj, st);
    case 7: return launch<7, true, true, false, false, kGroupRegs>(sp, pl, jd, o, ex, m, nj, st);
    case 8: return launch<8, true, true, true, false, kGroupRegs>(sp, pl, jd, o, ex, m, nj, st);
    case 9: return launch<9, true, false, false, true, kGroupRegs>(sp, pl, jd, o, ex, m, nj, st);
    case 10: return launch<10, true, false, true, true, kGroupRegs>(sp, pl, jd, o, ex, m, nj, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
