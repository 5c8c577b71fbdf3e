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
//     (row, atom) pair of it has v2 < (r_i + r_j)^2;
//   * noscalar: the j-row is the script's constants (1, 2, 3, r*r = 3.1*3.1
//     rounded to f32, gid 7), folded by the compiler.
// Every operation is a separately rounded __f*_rn intrinsic in the
// script's order, so each variant equals its plain version bit for bit.
//
// Bound: FP32 issue, 7 instructions per margin (1 for nobig).  Layout:
// 256 threads, each 16 points x 4 atoms (a warp shares its points, so the
// sphere reads are broadcasts); per j-row each thread first computes v and
// the limit of its 4 atoms (about 14 instructions per atom, 1/8 of the
// margin work), then 64 margins.

#include "ke_common.cuh"

namespace {

using namespace ke;

enum Rows { kPerRow = 0, kGroupRegs = 1, kGroupSmem = 2 };

// One j-row (xk, yk, zk, rr = rk*rk, gk) against a thread's 16 x 4
// margins: v and the limit of its atoms, then the margins.
template <bool kGid, bool kBig, bool kFma, bool kHoist>
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
      if (!kBig) {
        mg = lim[k];
      } else if (kFma) {
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
template <int kVariant, bool kConst, bool kGid, bool kBig, bool kFma,
          bool kSkip, bool kHoist, int kRows>
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
  stream_row<kGid, kBig, kFma, kHoist>(at, occ, sreg, sph, xk, yk, zk, rr, gk)

  int groups_run = 0;
  if (kRows == kPerRow) {
    for (int j = 0; j < nj; ++j) {
      if (kConst) {
        // The script's Python constants; 3.1 * 3.1 rounds to 9.61f.
        KE_ROW(1.0f, 2.0f, 3.0f, 9.61f, 7.0f);
      } else {
        const float4 r = *reinterpret_cast<const float4*>(s.jd + j * kJCols);
        const float gk = s.jd[j * kJCols + 4];
        KE_ROW(r.x, r.y, r.z, __fmul_rn(r.w, r.w), gk);
      }
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

template <int kVariant, bool kConst, bool kGid, bool kBig, bool kFma,
          bool kSkip, bool kHoist, int kRows>
int launch(const float4* sphere, const float* planes, const float* jdata,
           float* out, int32_t* executed, int m, int nj, cudaStream_t stream) {
  return launch_tiles(
      ke_stream_kernel<kVariant, kConst, kGid, kBig, kFma, kSkip, kHoist,
                       kRows>,
      base_smem(nj), m, stream, sphere, planes, jdata, out, executed, m, nj);
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
    case 0: return launch<0, false, true, true, false, false, false, kPerRow>(sp, pl, jd, o, ex, m, nj, st);
    case 1: return launch<1, true, true, true, false, false, false, kPerRow>(sp, pl, jd, o, ex, m, nj, st);
    case 2: return launch<2, false, false, true, false, false, false, kPerRow>(sp, pl, jd, o, ex, m, nj, st);
    case 3: return launch<3, false, true, false, false, false, false, kPerRow>(sp, pl, jd, o, ex, m, nj, st);
    case 4: return launch<4, false, true, true, false, false, false, kGroupRegs>(sp, pl, jd, o, ex, m, nj, st);
    case 5: return launch<5, false, true, true, false, false, false, kGroupSmem>(sp, pl, jd, o, ex, m, nj, st);
    case 6: return launch<6, false, true, true, false, false, false, kGroupRegs>(sp, pl, jd, o, ex, m, nj, st);
    case 7: return launch<7, false, true, true, true, false, false, kGroupRegs>(sp, pl, jd, o, ex, m, nj, st);
    case 8: return launch<8, false, true, true, true, true, false, kGroupRegs>(sp, pl, jd, o, ex, m, nj, st);
    case 9: return launch<9, false, true, true, false, false, true, kGroupRegs>(sp, pl, jd, o, ex, m, nj, st);
    case 10: return launch<10, false, true, true, false, true, true, kGroupRegs>(sp, pl, jd, o, ex, m, nj, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
