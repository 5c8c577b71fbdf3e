// Loop micro-variants of the occlusion-count kernel for NVIDIA Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel built by `make_kernel(variant)`
// (scripts/r4_microkernel.py, launched by `run_variant_counts`).  It
// computes fused_count.cu's counts on the host-cull j-lists, entries
// (mask << 16) | j_tile, with the loop over a j-tile's admitted 8-atom
// groups reshaped:
//   prod    one admitted group per iteration (fused_count.cu's loop);
//   split2  two running-max arrays, even and odd j-rows, merged after the
//           pass: half the serial max chain per group;
//   g16     two admitted groups per iteration, g24 three; an odd tail
//           repeats the last group (an idempotent max), as the script's
//           glist[min(k*2+1, pos-1)] does;
//   nosmem  all 16 groups of every live entry, with the group's limit
//           offset by a gate of 0 (bit set) or -1e30 (bit clear): the
//           script's control for what group compaction saves.
// Every variant takes the max of the same margins, or of margins at or
// below -1e30 besides them (nosmem), so all give fused_count's counts.
//
// Bound: FP32 ALU throughput, as fused_count.cu (7 instructions per
// margin); nosmem does the margins of all 16 groups.  The TPU study asked
// which loop shape amortizes the per-group setup on the VPU; here the
// setup is already per (i, j) in registers and the question is what the
// register file and the scheduler make of longer unrolled bodies and of
// a second accumulator (2K live registers in split2).

#include "count_tile.cuh"

namespace {

using namespace rustsasa;

enum Variant { kProd = 0, kSplit2, kG16, kG24, kNoSmem, kVariants };

__device__ __forceinline__ int pop_group(uint32_t& mask) {
  const int g = __ffs(mask) - 1;
  mask &= mask - 1u;
  return g;
}

template <int K, int V>
__global__ void __launch_bounds__(kThreads, 1)
micro_count_kernel(const float* __restrict__ planes,   // [8, m]
                   const int32_t* __restrict__ jlist,  // [m/128, 128]
                   const float4* __restrict__ sphere,  // [p]
                   int32_t* __restrict__ out,          // [m]
                   int m, int p, int passes) {
  extern __shared__ float4 smem[];
  const int n_cover = passes * kSlices * K;
  float4* sph = smem;
  float* jrec = reinterpret_cast<float*>(smem + n_cover);
  int* cnt = reinterpret_cast<int*>(jrec + kRecords * kAtomTile);

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

  const int32_t* row = jlist + static_cast<int64_t>(tile) * kJlistRows;
  const int n_entries = min(max(row[0], 0), kJlistRows - 1);
  int accessible = 0;

  for (int pass = 0; pass < passes; ++pass) {
    __syncthreads();  // sphere and counters staged
    const int p0 = (pass * kSlices + slice) * K;
    float sx[K], sy[K], sz[K], occ[K], occ2[K];
    load_points<K>(sph, p0, kNegBig, sx, sy, sz, occ);
#pragma unroll
    for (int k = 0; k < K; ++k) occ2[k] = occ[k];
    for (int e = 0; e < n_entries; ++e) {
      const uint32_t entry = static_cast<uint32_t>(row[1 + e]);
      const int jt = static_cast<int>(entry & 0xFFFFu);
      uint32_t mask = entry >> 16;
      // Uniform over the CTA; nosmem streams every live entry.
      if (jt >= n_tiles || (V != kNoSmem && mask == 0u)) continue;
      load_j_tile(jrec, planes, mm, jt);
      if (V == kNoSmem) {
        for (int g = 0; g < kAtomTile / kJGroup; ++g) {
          const float gate = ((mask >> g) & 1u) ? 0.0f : kNegBig;
#pragma unroll
          for (int r = 0; r < kJGroup; ++r) {
            float vx, vy, vz;
            const float lim =
                __fadd_rn(row_lim(jrec, g * kJGroup + r, at, vx, vy, vz), gate);
            row_margins<K>(vx, vy, vz, lim, sx, sy, sz, occ);
          }
        }
      } else if (V == kSplit2) {
        while (mask != 0u) {
          const int g = pop_group(mask);
#pragma unroll
          for (int r = 0; r < kJGroup; r += 2) {
            stream_row<K>(jrec, g * kJGroup + r, at, sx, sy, sz, occ);
            stream_row<K>(jrec, g * kJGroup + r + 1, at, sx, sy, sz, occ2);
          }
        }
      } else if (V == kG16 || V == kG24) {
        while (mask != 0u) {
          const int g1 = pop_group(mask);
          const int g2 = mask != 0u ? pop_group(mask) : g1;
          stream_group<K>(jrec, g1, at, sx, sy, sz, occ);
          stream_group<K>(jrec, g2, at, sx, sy, sz, occ);
          if (V == kG24) {
            const int g3 = mask != 0u ? pop_group(mask) : g2;
            stream_group<K>(jrec, g3, at, sx, sy, sz, occ);
          }
        }
      } else {
        while (mask != 0u) {
          stream_group<K>(jrec, pop_group(mask), at, sx, sy, sz, occ);
        }
      }
    }
    if (V == kSplit2) {
#pragma unroll
      for (int k = 0; k < K; ++k) occ[k] = fmaxf(occ[k], occ2[k]);
    }
    accessible += count_accessible<K>(sph, p0, occ);
  }
  write_count(cnt, a, slice, accessible, out, i);
}

template <int K, int V>
int launch_variant(const float* planes, const int32_t* jlist,
                   const float4* sphere, int32_t* out, int m, int p,
                   int passes, cudaStream_t stream) {
  micro_count_kernel<K, V>
      <<<m / kAtomTile, kThreads, count_smem(passes, K), stream>>>(
          planes, jlist, sphere, out, m, p, passes);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const float* planes, const int32_t* jlist, const float4* sphere,
           int32_t* out, int m, int p, int passes, int variant,
           cudaStream_t stream) {
  switch (variant) {
    case kProd:
      return launch_variant<K, kProd>(planes, jlist, sphere, out, m, p,
                                      passes, stream);
    case kSplit2:
      return launch_variant<K, kSplit2>(planes, jlist, sphere, out, m, p,
                                        passes, stream);
    case kG16:
      return launch_variant<K, kG16>(planes, jlist, sphere, out, m, p,
                                     passes, stream);
    case kG24:
      return launch_variant<K, kG24>(planes, jlist, sphere, out, m, p,
                                     passes, stream);
    default:
      return launch_variant<K, kNoSmem>(planes, jlist, sphere, out, m, p,
                                        passes, stream);
  }
}

}  // namespace

// Launches the kernel on `stream` without synchronizing.  planes: f32
// [8, m] (rows x, y, z, r_eff, gid+1); jlist: i32 [m/128, 128]; sphere:
// f32 [p, 4]; out: i32 [m].  m is a positive multiple of 128, 0 < p <=
// 2048 and variant is 0-4 (prod, split2, g16, g24, nosmem).  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int micro_count_launch(const void* planes, const void* jlist,
                                  const void* sphere, void* out, int m,
                                  int p, int variant, void* stream) {
  int passes, k;
  if (m <= 0 || m % kAtomTile != 0 || variant < 0 || variant >= kVariants ||
      !count_split(p, &passes, &k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RUSTSASA_SWITCH_K(
      k, launch<K>(static_cast<const float*>(planes),
                   static_cast<const int32_t*>(jlist),
                   static_cast<const float4*>(sphere),
                   static_cast<int32_t*>(out), m, p, passes, variant,
                   static_cast<cudaStream_t>(stream)))
}
