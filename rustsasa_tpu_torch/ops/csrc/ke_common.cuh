// What the kernel-experiment kernels share (ke_stream.cu, ke_maxplus.cu,
// ke_bf16.cu, ke_mxu.cu): the ports of scripts/kernel_experiments.py's six
// `make_*` Pallas kernels, for NVIDIA Hopper (sm_90a).
//
// One CTA per 128-atom i-tile, of kThreads threads (ke_maxplus.cu: 512).
// It stages, once:
//   * the sphere, [128] float4 (x, y, z, 0);
//   * the i-atoms' records, [7][128] (x, y, z, r, gid, r*r,
//     0.5 / max(r, 1e-6)), the script's per-tile prologue;
//   * the resident j-data, [nj][8] floats (x, y, z, r, gid, 3 unused),
//     copied from a device tensor: the study measures reads of resident
//     j-data, so it is data, not constants the compiler could fold.
// Per 8-row group a kernel may take the script's reach vote
// (min over rows and atoms of v2 - (r_i + r_j)^2 < 0, CTA-uniform through
// __syncthreads_or, or group_entries' part of it for a kernel that places
// its own barrier), and at the end it stages its [128 points][128 atoms]
// running maxima through shared memory (over the j-data, which is no
// longer read) and one thread per atom sums p = 0..127 in order, as the
// plain version does.  Every f32 operation is a separately rounded
// __f*_rn intrinsic in the script's order (the build adds --fmad=false).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ke {

constexpr int kA = 128;       // i-atoms per tile and CTA
constexpr int kP = 128;       // sphere points
constexpr int kGroup = 8;     // j-rows per group
constexpr int kJCols = 8;     // floats per j-row
constexpr int kThreads = 256;
constexpr int kPts = 16;      // points per thread (f32 layouts)
constexpr int kAts = 4;       // atoms per thread (f32 layouts)
constexpr int kMaxNj = 2048;  // j-rows shared memory holds
constexpr int kRecords = 7;
constexpr float kNegBig = -1e30f;

// Floats of the region that holds the j-data, then the staged maxima.
__host__ __device__ constexpr int region_floats(int nj) {
  return nj * kJCols > kP * kA ? nj * kJCols : kP * kA;
}

// Bytes of the shared buffers every kernel has.
__host__ __device__ constexpr size_t base_smem(int nj) {
  return sizeof(float4) * kP + sizeof(float) * (kRecords * kA +
                                                region_floats(nj));
}

struct Smem {
  float4* sph;   // [kP]
  float* irec;   // [kRecords][kA]
  float* jd;     // [nj][kJCols], later the maxima [kP][kA]
  float* extra;  // a kernel's own buffers
};

__device__ __forceinline__ Smem carve(void* raw, int nj) {
  Smem s;
  s.sph = static_cast<float4*>(raw);
  s.irec = reinterpret_cast<float*>(s.sph + kP);
  s.jd = s.irec + kRecords * kA;
  s.extra = s.jd + region_floats(nj);
  return s;
}

// Stages the sphere, the tile's i-atom records and the j-data; a CTA of
// kNThreads threads.
template <int kNThreads = kThreads>
__device__ __forceinline__ void stage_inputs(const Smem& s,
                                             const float4* __restrict__ sphere,
                                             const float* __restrict__ planes,
                                             const float* __restrict__ jdata,
                                             int64_t m, int nj) {
  const int tid = threadIdx.x;
  for (int q = tid; q < kP; q += kNThreads) s.sph[q] = sphere[q];
  if (tid < kA) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kA + tid;
    const float r = planes[3 * m + i];
    s.irec[0 * kA + tid] = planes[i];
    s.irec[1 * kA + tid] = planes[m + i];
    s.irec[2 * kA + tid] = planes[2 * m + i];
    s.irec[3 * kA + tid] = r;
    s.irec[4 * kA + tid] = planes[4 * m + i];
    s.irec[5 * kA + tid] = __fmul_rn(r, r);
    s.irec[6 * kA + tid] = __fdiv_rn(0.5f, fmaxf(r, 1e-6f));
  }
  const float4* src = reinterpret_cast<const float4*>(jdata);
  float4* dst = reinterpret_cast<float4*>(s.jd);
  for (int q = tid; q < nj * (kJCols / 4); q += kNThreads) dst[q] = src[q];
  __syncthreads();
}

// One i-atom's record in registers.
struct IAtom {
  float x, y, z, r, gid, r2, inv2r;
};

__device__ __forceinline__ IAtom i_atom(const float* irec, int a) {
  return IAtom{irec[a], irec[kA + a], irec[2 * kA + a], irec[3 * kA + a],
               irec[4 * kA + a], irec[5 * kA + a], irec[6 * kA + a]};
}

// v = c_i - c_j, v2 = (vx*vx + vy*vy) + vz*vz and the limit
// ((rr - v2) - r_i*r_i) * inv2r_i, -1e30 where gid_i == gid_j or
// gid_j == 0 (kGid); rr is r_j * r_j.
template <bool kGid>
__device__ __forceinline__ float limit(const IAtom& at, float xk, float yk,
                                       float zk, float rr, float gk,
                                       float& vx, float& vy, float& vz,
                                       float& v2) {
  vx = __fsub_rn(at.x, xk);
  vy = __fsub_rn(at.y, yk);
  vz = __fsub_rn(at.z, zk);
  v2 = __fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)),
                 __fmul_rn(vz, vz));
  const float lim =
      __fmul_rn(__fsub_rn(__fsub_rn(rr, v2), at.r2), at.inv2r);
  return (kGid && (at.gid == gk || gk == 0.0f)) ? kNegBig : lim;
}

// The reach test's term for one (row, atom): v2 - (r_i + r_j)^2 < 0.
__device__ __forceinline__ bool reaches(float v2, float ri, float rk) {
  const float reach = __fadd_rn(ri, rk);
  return __fsub_rn(v2, __fmul_rn(reach, reach)) < 0.0f;
}

// A thread's share of the group prologue, without a barrier: thread t of
// kThreads takes atom t % 128 and rows (t / 128) * 4 + 0..3 of the 8-row
// group at `rows` (atom record `at`, i_atom(irec, t % 128)), hands each
// (row, atom)'s v and limit to store(r, a, vx, vy, vz, lim), and returns
// its part of the reach vote.
template <bool kGid, typename Store>
__device__ __forceinline__ bool group_entries(const IAtom& at,
                                              const float* rows,
                                              Store store) {
  constexpr int kRowsPerThread = kGroup * kA / kThreads;
  const int a = threadIdx.x % kA;
  const int r0 = (threadIdx.x / kA) * kRowsPerThread;
  bool hit = false;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int r = r0 + q;
    const float* row = rows + r * kJCols;
    float vx, vy, vz, v2;
    const float lim = limit<kGid>(at, row[0], row[1], row[2],
                                  __fmul_rn(row[3], row[3]), row[4], vx, vy,
                                  vz, v2);
    store(r, a, vx, vy, vz, lim);
    hit |= reaches(v2, at.r, row[3]);
  }
  return hit;
}

// The group prologue: group_entries, then the CTA's vote; the barrier
// also publishes what store wrote.
template <bool kGid, typename Store>
__device__ __forceinline__ bool group_prologue(const float* irec,
                                               const float* rows,
                                               Store store) {
  const IAtom at = i_atom(irec, threadIdx.x % kA);
  return __syncthreads_or(group_entries<kGid>(at, rows, store)) != 0;
}

// The reach vote alone (ke_stream.cu, whose rows live in registers).
__device__ __forceinline__ bool group_vote(const float* irec,
                                           const float* rows) {
  return group_prologue<true>(irec, rows,
                              [](int, int, float, float, float, float) {});
}

// Sums the staged maxima [kP][kA] over the points, in order, into
// out[tile * 128 + a]; writes the tile's executed groups.  Call after
// every thread has written its maxima to s.jd.
__device__ __forceinline__ void finish(const Smem& s, float* __restrict__ out,
                                       int32_t* __restrict__ executed,
                                       int groups_run) {
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < kA) {
    float acc = s.jd[tid];
    for (int p = 1; p < kP; ++p) acc = __fadd_rn(acc, s.jd[p * kA + tid]);
    out[static_cast<int64_t>(blockIdx.x) * kA + tid] = acc;
  }
  if (tid == 0) executed[blockIdx.x] = groups_run;
}

// Stages a thread's maxima of the f32 layouts: points p0 + 0..kN-1, atoms
// a0 + 0..3.
template <int kN>
__device__ __forceinline__ void stage_occ(const Smem& s,
                                          const float (&occ)[kN][kAts],
                                          int p0, int a0) {
  __syncthreads();  // the j-data is no longer read
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    *reinterpret_cast<float4*>(s.jd + (p0 + q) * kA + a0) =
        make_float4(occ[q][0], occ[q][1], occ[q][2], occ[q][3]);
  }
}

// bf16 pair (lo, hi) as the 32-bit register an mma fragment takes.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D = A * B (m16n8k16, bf16 in, f32 accumulate from zero) on the tensor
// cores.  a: the 4 A registers, b: the 2 B registers of this lane.
__device__ __forceinline__ void mma_bf16(const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         float (&d)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// Launches `kernel` with `smem` bytes of dynamic shared memory, one CTA of
// kNThreads threads per i-tile; returns the cudaError_t of the launch.
template <int kNThreads = kThreads, typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, size_t smem, int m, cudaStream_t stream,
                 Args... args) {
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<m / kA, kNThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The checks every launcher makes: m a positive multiple of 128, nj a
// positive multiple of `rows` that shared memory holds.
inline bool valid_shape(int m, int nj, int rows) {
  return m > 0 && m % kA == 0 && nj > 0 && nj % rows == 0 && nj <= kMaxNj;
}

}  // namespace ke
