// The per-j dot products of the kernel experiments on a matrix unit, for
// NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `make_mxu_dots_kernel(precision, skip)`
// (scripts/kernel_experiments.py:502; mxu_dots_hi, mxu_dots_def,
// mxu_dots_hi_skip).  Per j-row the script takes the dots
// s_p.(c_i - c_j) as one [P, 8] x [8, A] product on the TPU's matrix unit
// (rows vx, vy, vz and five zeros), so that the vector unit only does
// occ = max(occ, lim - dots).  Per 8-row group a prologue computes each
// (row, atom)'s v and limit once into shared memory (the script's
// [8, A] group arrays), with the reach vote of `skip`.  Then, per row:
//   * HIGHEST (hi, hi_skip): the products in full f32 on the CUDA cores,
//     in the order XLA-CPU's zero-padded K = 8 dot takes them,
//     fma(s_z, vz, fma(s_y, vy, s_x*vx)); 16 points x 4 atoms a thread;
//   * DEFAULT (def): what a TPU runs as one bf16 pass with f32
//     accumulation, on the tensor cores with Hopper's warpgroup product,
//     transposed: D[atom][point] = V[atom][k] S[k][point].  Warpgroup w
//     (threads 128w..128w+127) owns atoms 64w..64w+63 and all 128 points:
//     per row two wgmma.mma_async m64n64k16 (points 0..63 and 64..127),
//     A = the row's (vx, vy, vz, 0...) bf16 [64 x 16] (K padded 3 -> 16)
//     in registers, two 32-bit loads a thread from the group prologue's
//     (vx, vy) and (vz, 0) pairs, B = the sphere bf16 [16 x 128], written
//     once K-major in the no-swizzle canonical layout (8 points x 16 B core
//     matrices, the second K half zero) and handed over through a matrix
//     descriptor.  The products of bf16 operands are exact; the tensor
//     core sums them in its own order, so its dots may lie a few ulp from
//     the plain version's ((p_x + p_y) + p_z), within the bound
//     kernel_experiments.default_bound states.
// No library product: the products are issued from this kernel's body.
//
// Bound: FP32 issue, 5 instructions per margin for HIGHEST (mul, 2 fma,
// sub, max) and 2 for DEFAULT (sub, max) beside 2 x 64 x 128 x 16 MACs
// per row and tile on the tensor cores.  The DEFAULT design keeps the
// tensor cores under the FP32 work: the two products of a row go into two
// accumulators, and one is in flight (wgmma.commit_group,
// wgmma.wait_group 1) while the other's epilogue occ = max(occ, lim - d)
// runs, within each 8-row group.  In the transposed layout a thread's
// accumulator rows are two atoms, so a row's limits are two loads a thread
// (not one per column), and both accumulators and occ fit in registers
// without spills (chip_smoke.py prints ptxas's count).  The group buffers
// alternate over two slots, so each group costs one barrier.  On the card
// the tensor-core path does not hide under the FP32 path, however deep or
// ordered the products' pipeline (scripts/mxu_overlap.py times each path
// alone): PERF.md has the numbers.

#include "ke_common.cuh"

namespace {

using namespace ke;

// HIGHEST per-group buffers: vx, vy, vz, lim [8][128] f32.
constexpr int kGroupFloats = 4 * kGroup * kA;
constexpr size_t kExtra = sizeof(float) * kGroupFloats;

// DEFAULT buffers: the sphere as the B operand, [16 point octets]
// [2 K halves][8 points] x 16 B (core matrices of 8 points x 8 bf16 K,
// K halves 128 B apart, octets 256 B apart; the second K half zero),
// then kSlots group slots of [8 rows][128 atoms] u32 (vx, vy) bf16 pairs,
// u32 (vz, 0) pairs and f32 limits.
constexpr int kCoreBytes = 8 * 16;
constexpr int kOctetBytes = 2 * kCoreBytes;
constexpr int kSphereBytes = (kP / 8) * kOctetBytes;
constexpr int kSlotWords = 3 * kGroup * kA;
constexpr int kSlots = 2;
// Each row's product is taken in kParts parts of kPartN points (a
// kPartRegs-float accumulator each), kPartDesc apart in descriptor units.
constexpr int kParts = 2;
constexpr int kPartN = kP / kParts;
constexpr int kPartRegs = kPartN / 2;
constexpr uint64_t kPartDesc = (kPartN / 8) * kOctetBytes >> 4;
static_assert(kPartN == 64, "wgmma_m64n64 takes 64 points a part");
constexpr size_t kDefExtra =
    kSphereBytes + sizeof(uint32_t) * kSlots * kSlotWords;

template <bool kSkip>
__global__ void __launch_bounds__(kThreads, 1)
ke_mxu_kernel(const float4* __restrict__ sphere,
              const float* __restrict__ planes,
              const float* __restrict__ jdata, float* __restrict__ out,
              int32_t* __restrict__ executed, int m, int nj) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(smem_raw, nj);
  stage_inputs(s, sphere, planes, jdata, m, nj);
  float* gv = s.extra;  // [4][8][128]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // Points p0 + 0..15, atoms a0 + 0..3.
  const int a0 = lane * kAts;
  const int p0 = warp * kPts;

  float occ[kPts][kAts];
#pragma unroll
  for (int q = 0; q < kPts; ++q)
#pragma unroll
    for (int k = 0; k < kAts; ++k) occ[q][k] = kNegBig;
  float4 sreg[kPts];
#pragma unroll
  for (int q = 0; q < kPts; ++q) sreg[q] = s.sph[p0 + q];

  int groups_run = 0;
  for (int g = 0; g < nj / kGroup; ++g) {
    __syncthreads();  // the previous group's buffers are read
    const bool hit = group_prologue<true>(
        s.irec, s.jd + g * kGroup * kJCols,
        [&](int r, int a, float vx, float vy, float vz, float lim) {
          const int e = r * kA + a;
          gv[e] = vx;
          gv[kGroup * kA + e] = vy;
          gv[2 * kGroup * kA + e] = vz;
          gv[3 * kGroup * kA + e] = lim;
        });
    if (kSkip && !hit) continue;
    ++groups_run;
#pragma unroll 1
    for (int r = 0; r < kGroup; ++r) {
      const int e = r * kA;
      const float4 vx = *reinterpret_cast<const float4*>(gv + e + a0);
      const float4 vy =
          *reinterpret_cast<const float4*>(gv + kGroup * kA + e + a0);
      const float4 vz =
          *reinterpret_cast<const float4*>(gv + 2 * kGroup * kA + e + a0);
      const float4 lm =
          *reinterpret_cast<const float4*>(gv + 3 * kGroup * kA + e + a0);
      const float vxs[4] = {vx.x, vx.y, vx.z, vx.w};
      const float vys[4] = {vy.x, vy.y, vy.z, vy.w};
      const float vzs[4] = {vz.x, vz.y, vz.z, vz.w};
      const float lms[4] = {lm.x, lm.y, lm.z, lm.w};
#pragma unroll
      for (int q = 0; q < kPts; ++q) {
        const float4 sp = sreg[q];
#pragma unroll
        for (int k = 0; k < kAts; ++k) {
          const float dots = __fmaf_rn(
              sp.z, vzs[k], __fmaf_rn(sp.y, vys[k], __fmul_rn(sp.x, vxs[k])));
          occ[q][k] = fmaxf(occ[q][k], __fsub_rn(lms[k], dots));
        }
      }
    }
  }
  stage_occ(s, occ, p0, a0);
  finish(s, out, executed, groups_run);
}

// Matrix descriptor of a K-major bf16 operand at `p` in the no-swizzle
// canonical layout: core matrices of 8 rows x 16 B, the next one along K
// (leading dimension) kCoreBytes on, the next 8 rows kOctetBytes on.
__device__ __forceinline__ uint64_t b_descriptor(const void* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(kCoreBytes >> 4) << 16 |
         static_cast<uint64_t>(kOctetBytes >> 4) << 32;
}

// Keep the compiler from moving accesses of these registers across this
// point: a wgmma reads its A registers and writes its accumulator
// asynchronously, behind the compiler's back.
__device__ __forceinline__ void fence_regs(float (&d)[kPartRegs]) {
#pragma unroll
  for (int i = 0; i < kPartRegs; ++i) {
    asm volatile("" : "+f"(d[i])::"memory");
  }
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d = A * B on the tensor cores, asynchronously: A [64 x 16] bf16 from the
// warpgroup's registers (a: this thread's 4), B [16 x 64] bf16 through
// descriptor `desc`, f32 d [32 a thread] in the accumulator layout, not
// accumulated (scale-d = 0).
__device__ __forceinline__ void wgmma_m64n64(float (&d)[kPartRegs],
                                             uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0)
      : "memory");
}

// Fences the registers, issues the product and commits it as a group.
__device__ __forceinline__ void wgmma_issue(float (&d)[kPartRegs],
                                            uint32_t (&a)[4],
                                            uint64_t desc) {
  fence_regs(d);
  fence_regs(a);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_m64n64(d, a, desc);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most W committed products are in flight, then fences
// the accumulator of the one that finished.
template <int W>
__device__ __forceinline__ void wgmma_wait(float (&d)[kPartRegs]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(W) : "memory");
  fence_regs(d);
}

// One row's operands for this thread: its A registers (atoms a0 and
// a0 + 8 of the warp's 16, K pairs 2*tig, 2*tig + 1: (vx, vy) for tig 0,
// (vz, 0) for tig 1, zero above) and the two atoms' limits.
__device__ __forceinline__ void load_row(const uint32_t* slot, int r, int a0,
                                         int tig, uint32_t (&a)[4],
                                         float& la, float& lb) {
  const uint32_t* src = slot + (tig == 0 ? 0 : kGroup * kA) + r * kA + a0;
  a[0] = tig < 2 ? src[0] : 0u;
  a[1] = tig < 2 ? src[8] : 0u;
  a[2] = 0u;
  a[3] = 0u;
  const float* lim =
      reinterpret_cast<const float*>(slot + 2 * kGroup * kA) + r * kA + a0;
  la = lim[0];
  lb = lim[8];
}

// occ = max(occ, lim - d) for one row and part: d in the accumulator
// layout (n-tile nt: d[4nt + c], atom a0 + 8 for c >= 2, point
// nt*8 + 2*tig + (c & 1) of the part), la and lb the limits of atoms a0
// and a0 + 8.
__device__ __forceinline__ void epilogue(float* occ,
                                         const float (&d)[kPartRegs],
                                         float la, float lb) {
#pragma unroll
  for (int nt = 0; nt < kPartRegs / 4; ++nt) {
    occ[4 * nt + 0] = fmaxf(occ[4 * nt + 0], __fsub_rn(la, d[4 * nt + 0]));
    occ[4 * nt + 1] = fmaxf(occ[4 * nt + 1], __fsub_rn(la, d[4 * nt + 1]));
    occ[4 * nt + 2] = fmaxf(occ[4 * nt + 2], __fsub_rn(lb, d[4 * nt + 2]));
    occ[4 * nt + 3] = fmaxf(occ[4 * nt + 3], __fsub_rn(lb, d[4 * nt + 3]));
  }
}

// Group g's prologue into `slot`; its barrier also publishes the slot.
__device__ __forceinline__ void prologue_def(const Smem& s, uint32_t* slot,
                                             int g) {
  float* lims = reinterpret_cast<float*>(slot + 2 * kGroup * kA);
  group_prologue<true>(
      s.irec, s.jd + g * kGroup * kJCols,
      [&](int r, int a, float vx, float vy, float vz, float lim) {
        const int e = r * kA + a;
        slot[e] = pack_bf16(vx, vy);
        slot[kGroup * kA + e] = pack_bf16(vz, 0.0f);
        lims[e] = lim;
      });
}

__global__ void __launch_bounds__(kThreads, 1)
ke_mxu_def_kernel(const float4* __restrict__ sphere,
                  const float* __restrict__ planes,
                  const float* __restrict__ jdata, float* __restrict__ out,
                  int32_t* __restrict__ executed, int m, int nj) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(smem_raw, nj);
  stage_inputs(s, sphere, planes, jdata, m, nj);
  unsigned char* bsph = reinterpret_cast<unsigned char*>(s.extra);
  uint32_t* slots = reinterpret_cast<uint32_t*>(bsph + kSphereBytes);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // Accumulator rows (atoms) a0 and a0 + 8, columns (points)
  // nt*8 + 2*tig + {0, 1}.
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int a0 = warp * 16 + gid;

  // The sphere as B, once; the tensor cores read it through the async
  // proxy, so the writes are fenced before the first prologue's barrier.
  for (int q = tid; q < 2 * kP; q += kThreads) {
    const int pt = q / 2;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q % 2 == 0) {
      const float4 sp = s.sph[pt];
      v = make_uint4(pack_bf16(sp.x, sp.y), pack_bf16(sp.z, 0.0f), 0u, 0u);
    }
    *reinterpret_cast<uint4*>(bsph + (pt / 8) * kOctetBytes +
                              (q % 2) * kCoreBytes + (pt % 8) * 16) = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint64_t desc = b_descriptor(bsph);

  float occ[64];  // kParts parts of kPartRegs, in point order
#pragma unroll
  for (int i = 0; i < 64; ++i) occ[i] = kNegBig;
  float acc[kParts][kPartRegs];
#pragma unroll
  for (int q = 0; q < kParts; ++q)
#pragma unroll
    for (int i = 0; i < kPartRegs; ++i) acc[q][i] = 0.0f;
  uint32_t fr[2][4];
  float la[2], lb[2];

  // Each row is kParts products of kPartN points; kParts - 1 are in
  // flight while one's epilogue runs.  The pipeline drains at the end of
  // each group: a product in flight across the group loop's back edge
  // makes ptxas serialize every wgmma of the kernel (warning C7514).  Per
  // group one barrier, its prologue's: slot g % 2 was last read in group
  // g - 2, which every thread finished before group g - 1's prologue.
  const int n_groups = nj / kGroup;
  for (int g = 0; g < n_groups; ++g) {
    uint32_t* cur = slots + (g % kSlots) * kSlotWords;
    prologue_def(s, cur, g);
    load_row(cur, 0, a0, tig, fr[0], la[0], lb[0]);
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      wgmma_issue(acc[q], fr[0], desc + q * kPartDesc);
    }
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int b = r & 1;  // this row's registers; the next row's: b ^ 1
      const bool more = r + 1 < kGroup;
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        // After the group's last issue, part q leaves kParts - 1 - q in
        // flight (kParts == 2).
        if (more || q == 0) {
          wgmma_wait<kParts - 1>(acc[q]);
        } else {
          wgmma_wait<0>(acc[q]);
        }
        // Row r's A registers are read until its last part finished.
        if (q == kParts - 1) fence_regs(fr[b]);
        epilogue(occ + q * kPartRegs, acc[q], la[b], lb[b]);
        if (more) {
          if (q == 0) {
            load_row(cur, r + 1, a0, tig, fr[b ^ 1], la[b ^ 1], lb[b ^ 1]);
          }
          wgmma_issue(acc[q], fr[b ^ 1], desc + q * kPartDesc);
        }
      }
    }
  }
  __syncthreads();  // the j-data is no longer read
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int pt =
        (i / kPartRegs) * kPartN + (i % kPartRegs / 4) * 8 + 2 * tig + (i & 1);
    s.jd[pt * kA + a0 + 8 * (i / 2 % 2)] = occ[i];
  }
  finish(s, out, executed, n_groups);
}

}  // namespace

// Launches variant `variant` (0 mxu_dots_hi, 1 mxu_dots_def,
// 2 mxu_dots_hi_skip) on `stream` without synchronizing; arguments as
// ke_stream_launch's.  Returns the cudaError_t of the launch (0 = success).
extern "C" int ke_mxu_launch(const void* sphere, const void* planes,
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
    case 0:
      return launch_tiles(ke_mxu_kernel<false>, base_smem(nj) + kExtra, m, st,
                          sp, pl, jd, o, ex, m, nj);
    case 1:
      return launch_tiles(ke_mxu_def_kernel, base_smem(nj) + kDefExtra, m,
                          st, sp, pl, jd, o, ex, m, nj);
    case 2:
      return launch_tiles(ke_mxu_kernel<true>, base_smem(nj) + kExtra, m, st,
                          sp, pl, jd, o, ex, m, nj);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
