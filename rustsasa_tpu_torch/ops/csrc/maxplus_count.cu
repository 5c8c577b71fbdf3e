// Max-plus occlusion-count kernel for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `mp_static_kernel` (scripts/r3_maxplus.py,
// launched by `run_variant(variant="mp_static")`).  Kernel 1's margin
//     lim_ij - s_p.(c_i - c_j)
// is split into a part per (j, i), one per (p, j) and one per (p, i):
//     (LIMT[j, i] + TJ[p, j]) - SXI[p, i],
//     SXI[p, i] = s_p.c_i,  TJ[p, j] = s_p.c_j,
//     LIMT[j, i] = ((r_j*r_j - v2t) - r_i*r_i) * (0.5 / max(r_i, 1e-6)),
//     v2t = (|c_j|^2 - 2 c_j.c_i) + |c_i|^2,
// LIMT = -1e30 where gid_j == gid_i or gid_j == 0.  SXI does not depend on
// j, so it leaves the max: a point is accessible when
//     max_j (LIMT[j, i] + TJ[p, j]) - SXI[p, i] <= 0.
// The script computes the K = 3 products (SXI, TJ, c_j.c_i) with
// dot_general at HIGHEST precision and the squared norms with sum(c*c);
// on XLA's CPU backend each is the left-to-right fused chain
//     fma(a2, b2, fma(a1, b1, a0*b0)),
// and so is it here (dot3), in the kernel's own body: no library product.
// Every other operation is a separately rounded __f*_rn intrinsic in the
// script's order, so the counts equal the plain version's bit for bit.
// They may differ from kernel 1's at boundary points (another rounding).
//
// Bound: FP32 ALU throughput.  Per margin 2 instructions (add, max)
// against kernel 1's 7, plus a quarter of a shared-memory load: one CTA
// per i-tile as in fused_count.cu (512 threads = 128 atoms x 4 point
// slices, K <= 16 points per thread); per admitted entry the CTA writes
// the pass's TJ rows [4K][128] into shared memory (3 instructions per
// value, K values a thread), and per admitted group each thread takes its
// 8 LIMT values in registers and reads TJ[p][8 j] as two float4
// broadcasts per point (a warp's 32 atoms share p and j).

#include "count_tile.cuh"

namespace {

using namespace rustsasa;

// a0*b0 + a1*b1 + a2*b2 as XLA-CPU's K = 3 dot: fma(a2, b2, fma(a1, b1,
// a0*b0)).
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
maxplus_count_kernel(const float* __restrict__ planes,   // [8, m]
                     const int32_t* __restrict__ jlist,  // [m/128, 128]
                     const float4* __restrict__ sphere,  // [p]
                     int32_t* __restrict__ out,          // [m]
                     int m, int p, int passes) {
  constexpr int kPassPoints = kSlices * K;
  extern __shared__ float4 smem[];
  const int n_cover = passes * kPassPoints;
  float4* sph = smem;                                          // [n_cover]
  float* jrec = reinterpret_cast<float*>(smem + n_cover);      // [5][128]
  float* tj = jrec + kRecords * kAtomTile;                     // [4K][128]
  int* cnt = reinterpret_cast<int*>(tj + kPassPoints * kAtomTile);  // [128]

  const int tid = threadIdx.x;
  const int a = tid % kAtomTile;
  const int slice = tid / kAtomTile;
  const int tile = blockIdx.x;
  const int n_tiles = m / kAtomTile;
  const int64_t mm = m;
  const int64_t i = static_cast<int64_t>(tile) * kAtomTile + a;

  stage_sphere(sph, sphere, p, n_cover);
  if (tid < kAtomTile) cnt[tid] = 0;
  const IAtom at = load_i_atom(planes, mm, i);
  const float ci2 = dot3(at.x, at.x, at.y, at.y, at.z, at.z);

  const int32_t* row = jlist + static_cast<int64_t>(tile) * kJlistRows;
  const int n_entries = min(max(row[0], 0), kJlistRows - 1);
  int accessible = 0;

  for (int pass = 0; pass < passes; ++pass) {
    __syncthreads();  // sphere and counters staged
    const int p0 = (pass * kSlices + slice) * K;
    float sxi[K], occ[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 s = sph[p0 + k];
      sxi[k] = dot3(s.x, at.x, s.y, at.y, s.z, at.z);
      occ[k] = kNegBig;
    }
    for (int e = 0; e < n_entries; ++e) {
      const uint32_t entry = static_cast<uint32_t>(row[1 + e]);
      const int jt = static_cast<int>(entry & 0xFFFFu);
      uint32_t mask = entry >> 16;
      if (jt >= n_tiles || mask == 0u) continue;  // uniform over the CTA
      load_j_tile(jrec, planes, mm, jt);
      for (int q = tid; q < kPassPoints * kAtomTile; q += kThreads) {
        const float4 s = sph[pass * kPassPoints + q / kAtomTile];
        const int j = q % kAtomTile;
        tj[q] = dot3(s.x, jrec[j], s.y, jrec[kAtomTile + j], s.z,
                     jrec[2 * kAtomTile + j]);
      }
      __syncthreads();
      while (mask != 0u) {
        const int g = __ffs(mask) - 1;
        mask &= mask - 1u;
        float limt[kJGroup];
#pragma unroll
        for (int r = 0; r < kJGroup; ++r) {
          const int jj = g * kJGroup + r;
          const float xj = jrec[0 * kAtomTile + jj];
          const float yj = jrec[1 * kAtomTile + jj];
          const float zj = jrec[2 * kAtomTile + jj];
          const float rj = jrec[3 * kAtomTile + jj];
          const float gj = jrec[4 * kAtomTile + jj];
          const float cj2 = dot3(xj, xj, yj, yj, zj, zj);
          const float cji = dot3(xj, at.x, yj, at.y, zj, at.z);
          const float v2t = __fadd_rn(__fsub_rn(cj2, __fmul_rn(2.0f, cji)), ci2);
          const float lim = __fmul_rn(
              __fsub_rn(__fsub_rn(__fmul_rn(rj, rj), v2t), at.r2), at.inv2r);
          limt[r] = (at.gid == gj || gj == 0.0f) ? kNegBig : lim;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float4* t = reinterpret_cast<const float4*>(
              tj + (slice * K + k) * kAtomTile + g * kJGroup);
          const float4 t0 = t[0];
          const float4 t1 = t[1];
          float o = occ[k];
          o = fmaxf(o, __fadd_rn(limt[0], t0.x));
          o = fmaxf(o, __fadd_rn(limt[1], t0.y));
          o = fmaxf(o, __fadd_rn(limt[2], t0.z));
          o = fmaxf(o, __fadd_rn(limt[3], t0.w));
          o = fmaxf(o, __fadd_rn(limt[4], t1.x));
          o = fmaxf(o, __fadd_rn(limt[5], t1.y));
          o = fmaxf(o, __fadd_rn(limt[6], t1.z));
          occ[k] = fmaxf(o, __fadd_rn(limt[7], t1.w));
        }
      }
    }
    int n = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      n += (__fsub_rn(occ[k], sxi[k]) <= 0.0f && sph[p0 + k].w > 0.0f) ? 1 : 0;
    }
    accessible += n;
  }
  write_count(cnt, a, slice, accessible, out, i);
}

// The padded sphere, one j-tile, one pass's TJ rows, 128 counters.
inline size_t maxplus_smem(int passes, int k) {
  return sizeof(float4) * passes * kSlices * k +
         sizeof(float) * (kRecords + kSlices * k) * kAtomTile +
         sizeof(int) * kAtomTile;
}

template <int K>
int launch(const float* planes, const int32_t* jlist, const float4* sphere,
           int32_t* out, int m, int p, int passes, cudaStream_t stream) {
  const size_t smem = maxplus_smem(passes, K);
  // Above 48 KB (K = 16 with many passes) dynamic shared memory must be
  // allowed explicitly.
  const cudaError_t set = cudaFuncSetAttribute(
      maxplus_count_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  maxplus_count_kernel<K><<<m / kAtomTile, kThreads, smem, stream>>>(
      planes, jlist, sphere, out, m, p, passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  planes: f32
// [8, m] (rows x, y, z, r_eff, gid+1); jlist: i32 [m/128, 128] with
// entries (mask << 16) | j_tile; sphere: f32 [p, 4]; out: i32 [m].  m is
// a positive multiple of 128 and 0 < p <= 2048.  Returns the cudaError_t
// of the launch (0 = success).
extern "C" int maxplus_count_launch(const void* planes, const void* jlist,
                                    const void* sphere, void* out, int m,
                                    int p, void* stream) {
  int passes, k;
  if (m <= 0 || m % kAtomTile != 0 || !count_split(p, &passes, &k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RUSTSASA_SWITCH_K(
      k, launch<K>(static_cast<const float*>(planes),
                   static_cast<const int32_t*>(jlist),
                   static_cast<const float4*>(sphere),
                   static_cast<int32_t*>(out), m, p, passes,
                   static_cast<cudaStream_t>(stream)))
}
