// Device-side dequant and banded cull for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the XLA stages that the JAX package runs in one jit around its
// count kernel (rustsasa_tpu/ops/fused_kernel.py, fused_sasa_q13_banded
// and fused_sasa_q16_banded), so that a banded chunk is three kernels:
// dequant_boxes, band_jlist and fused_count.cu.
//
// dequant_boxes (the wire dequant, :442-470 and :730-744, and the box
// reductions at the head of build_jlist_banded, :599-610).  One CTA of
// 128 threads a 128-atom tile, one thread a slot.  From the q13 wire
// (u32 qx|qy|qz_hi, u16 qz_lo|palette index) or the q16 wire (four u16
// planes) it writes the [8, m] f32 planes (x, y, z = q * scale + origin,
// multiply then add; r_eff; gid = slot + 1 for a real slot, else 0; rows
// 5-7 zero), qvalid [m] and each tile's boxes: the 8-atom groups' min /
// max corner [T, 16, 3] and largest r_eff [T, 16], the tile's [T, 3] and
// [T].  Padding slots count as +3e4 / -3e4 and r = 0.  Given no boxes
// (the host-cull route, which has its j-lists) it writes the planes and
// qvalid alone; a third mode reads f32 planes and qvalid and writes only
// the boxes.  Bound: bytes (6 or 8 B in, 33 B out a slot); the reductions
// are warp shuffles, and a min or max is exact in any order.
//
// band_jlist (the rest of build_jlist_banded, :612-711).  One CTA of 128
// threads an i-tile, one i-atom a thread, in registers.  For each of the
// nd = 2w - 1 offsets d the j-tile is j = i + d - (w - 1); its boxes are
// zeros outside [0, T), as the reference's zero padding gives them.  It
//   * tests the tile pair: valid = start_i <= j < start_i + len_i,
//     gap = max(max(tmin_i - tmax_j, tmin_j - tmax_i), 0),
//     sep2 = (gx*gx + gy*gy) + gz*gz, act = valid and
//     sep2 <= ((tmaxr_i + tmaxr_j) + 0.01)^2;
//   * sets group g's mask bit when some i-atom has rr*rr - pb2 >= 0, pb2
//     the point-to-box (_sum3 of the clamped gaps), rr = (r_i +
//     gmaxr_j[g]) + 0.01.  The reference takes the max of rr*rr - pb2 over
//     the 128 atoms, then >= 0; for finite inputs (every wire's are) an OR
//     of the atoms' own tests gives the same bits, here a warp reduction
//     and a shared-memory atomicOr;
//   * keeps act only where the mask is not 0 and the entry (mask << 16) |
//     j as a u32 word (the low 32 bits of the reference's int arithmetic,
//     so a negative j or mask bit 15 wraps as there);
//   * sorts the nd entries by act ? sep2 : +inf, ascending and stable
//     (ties keep offset order; sep2 = 0 ties between touching tiles and
//     +inf ties are common), by rank: rank = #{key' < key} + #{earlier
//     e' : key' == key}, nd <= 253;
//   * writes the [128] row: column 0 the count of active entries, columns
//     1..min(nd, 127) the sorted entries (inactive ones and those past
//     the chunk's ends included), 0 elsewhere.
// Every offset's mask is computed, whether the pair is active or not,
// because the inactive entries fill the row's tail.  Bound: operations
// (~22 FP32 instructions a point-box test, T x nd x 16 x 128 tests).  The
// j-groups' boxes are staged in shared memory 32 offsets at a time
// (contiguous tiles, coalesced), each group as two float4 broadcasts.
// Every float operation is an explicitly rounded __f*_rn intrinsic in the
// reference's order (the library is also built with --fmad=false), so
// the j-lists equal the plain builder's byte for byte.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kAtomTile = 128;
constexpr int kGroups = 16;
constexpr int kJGroup = 8;
constexpr int kPlanes = 8;
constexpr int kJlistRows = 128;
constexpr int kJlistCap = kJlistRows - 1;
constexpr int kMaxW = 127;
constexpr int kMaxOffsets = 2 * kMaxW - 1;
constexpr int kChunk = 32;  // offsets whose j-group boxes are staged at once
constexpr int kWarps = kAtomTile / 32;
constexpr float kBig = 3e4f;
constexpr float kSlack = 0.01f;
constexpr float kInvRQuant = 1.0f / 8192.0f;  // exact: 2^-13

enum Wire { kQ13 = 0, kQ16 = 1, kFromPlanes = 2 };

struct Boxes {
  float* gmin;   // [T, 16, 3]
  float* gmax;   // [T, 16, 3]
  float* gmaxr;  // [T, 16]
  float* tmin;   // [T, 3]
  float* tmax;   // [T, 3]
  float* tmaxr;  // [T]
};

template <int W>
__global__ void __launch_bounds__(kAtomTile)
dequant_boxes_kernel(const void* __restrict__ in0,
                     const void* __restrict__ in1,
                     const float* __restrict__ palette,
                     const float* __restrict__ tparams,
                     float* __restrict__ planes, uint8_t* __restrict__ qvalid,
                     Boxes boxes, int m) {
  const int a = threadIdx.x;
  const int lane = a & 31;
  const int warp = a >> 5;
  const int tile = blockIdx.x;
  const int64_t mm = m;
  const int64_t slot = static_cast<int64_t>(tile) * kAtomTile + a;

  float c[3], r;
  bool valid;
  if (W == kFromPlanes) {
    const float* p = static_cast<const float*>(in0);
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = p[k * mm + slot];
    r = p[3 * mm + slot];
    valid = static_cast<const uint8_t*>(in1)[slot] != 0;
  } else {
    float q[3];
    if (W == kQ13) {
      const uint32_t wa = static_cast<const uint32_t*>(in0)[slot];
      const uint32_t wb = static_cast<const uint16_t*>(in1)[slot];
      q[0] = static_cast<float>(wa & 0x1FFFu);
      q[1] = static_cast<float>((wa >> 13) & 0x1FFFu);
      q[2] = static_cast<float>((((wa >> 26) & 0x3Fu) << 7) | (wb & 0x7Fu));
      const uint32_t ridx = (wb >> 7) & 0xFFu;
      valid = ridx > 0u;
      r = palette[ridx];
    } else {
      const uint16_t* p4 = static_cast<const uint16_t*>(in0);
#pragma unroll
      for (int k = 0; k < 3; ++k) q[k] = static_cast<float>(p4[k * mm + slot]);
      const float qr = static_cast<float>(p4[3 * mm + slot]);
      valid = qr > 0.0f;
      r = __fmul_rn(qr, kInvRQuant);
    }
    const float* par = tparams + 4 * static_cast<int64_t>(tile);
    const float scale = par[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[k] = __fadd_rn(__fmul_rn(q[k], scale), par[k]);
      planes[k * mm + slot] = c[k];
    }
    planes[3 * mm + slot] = r;
    // Exact while m < 2^24 (the launcher refuses more).
    planes[4 * mm + slot] =
        valid ? __fadd_rn(static_cast<float>(slot), 1.0f) : 0.0f;
#pragma unroll
    for (int row = 5; row < kPlanes; ++row) planes[row * mm + slot] = 0.0f;
    qvalid[slot] = valid ? 1 : 0;
  }
  if (boxes.gmin == nullptr) return;  // the same for every thread

  // v[0..2]: min corner, v[3..5]: max corner, v[6]: largest r_eff.
  float v[7];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = valid ? c[k] : kBig;
    v[3 + k] = valid ? c[k] : -kBig;
  }
  v[6] = valid ? r : 0.0f;
  // The 8 lanes of a group, then the 4 groups of a warp.
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], s));
      v[3 + k] = fmaxf(v[3 + k], __shfl_xor_sync(0xffffffffu, v[3 + k], s));
    }
    v[6] = fmaxf(v[6], __shfl_xor_sync(0xffffffffu, v[6], s));
    if (s == kJGroup / 2 && (lane & (kJGroup - 1)) == 0) {
      const int64_t g = static_cast<int64_t>(tile) * kGroups + a / kJGroup;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        boxes.gmin[3 * g + k] = v[k];
        boxes.gmax[3 * g + k] = v[3 + k];
      }
      boxes.gmaxr[g] = v[6];
    }
  }
  __shared__ float part[kWarps][7];
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 7; ++k) part[warp][k] = v[k];
  }
  __syncthreads();
  if (a == 0) {
    for (int w = 1; w < kWarps; ++w) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        v[k] = fminf(v[k], part[w][k]);
        v[3 + k] = fmaxf(v[3 + k], part[w][3 + k]);
      }
      v[6] = fmaxf(v[6], part[w][6]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      boxes.tmin[3 * tile + k] = v[k];
      boxes.tmax[3 * tile + k] = v[3 + k];
    }
    boxes.tmaxr[tile] = v[6];
  }
}

__device__ __forceinline__ float sum3_sq(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// max(max(lo, hi), 0), as the reference's clamp of the larger gap.
__device__ __forceinline__ float gap(float lo, float hi) {
  return fmaxf(fmaxf(lo, hi), 0.0f);
}

__global__ void __launch_bounds__(kAtomTile)
band_jlist_kernel(const float* __restrict__ planes,
                  const uint8_t* __restrict__ qvalid,
                  const int32_t* __restrict__ tmeta, Boxes boxes,
                  int32_t* __restrict__ jlist, int m, int w) {
  // Offset dd of the chunk, group g: min x, y, z, max x | max y, z, r, 0.
  __shared__ float4 s_box[kChunk][kGroups][2];
  __shared__ uint32_t s_mask[kMaxOffsets];
  __shared__ float s_key[kMaxOffsets];
  __shared__ uint32_t s_entry[kMaxOffsets];
  __shared__ int32_t s_row[kJlistRows];
  __shared__ int s_count;

  const int a = threadIdx.x;
  const int lane = a & 31;
  const int tile = blockIdx.x;
  const int t = m / kAtomTile;
  const int nd = 2 * w - 1;
  const int64_t mm = m;
  const int64_t slot = static_cast<int64_t>(tile) * kAtomTile + a;

  // The i-atom as band_boxes' c_t and r_t: far away, r = 0 for padding.
  const bool valid = qvalid[slot] != 0;
  float c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = valid ? planes[k * mm + slot] : kBig;
  const float r = valid ? planes[3 * mm + slot] : 0.0f;

  for (int e = a; e < nd; e += kAtomTile) s_mask[e] = 0u;
  s_row[a] = 0;
  if (a == 0) s_count = 0;

  for (int d0 = 0; d0 < nd; d0 += kChunk) {
    const int nc = min(kChunk, nd - d0);
    const int j0 = tile + d0 - (w - 1);
    __syncthreads();  // the previous chunk consumed; masks zeroed
    for (int x = a; x < nc * kGroups; x += kAtomTile) {
      const int dd = x / kGroups;
      const int g = x % kGroups;
      const int j = j0 + dd;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 hi = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j >= 0 && j < t) {
        const int64_t jg = static_cast<int64_t>(j) * kGroups + g;
        lo = make_float4(boxes.gmin[3 * jg], boxes.gmin[3 * jg + 1],
                         boxes.gmin[3 * jg + 2], boxes.gmax[3 * jg]);
        hi = make_float4(boxes.gmax[3 * jg + 1], boxes.gmax[3 * jg + 2],
                         boxes.gmaxr[jg], 0.f);
      }
      s_box[dd][g][0] = lo;
      s_box[dd][g][1] = hi;
    }
    __syncthreads();
    for (int dd = 0; dd < nc; ++dd) {
      uint32_t bits = 0u;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 lo = s_box[dd][g][0];
        const float4 hi = s_box[dd][g][1];
        const float gx = gap(__fsub_rn(lo.x, c[0]), __fsub_rn(c[0], lo.w));
        const float gy = gap(__fsub_rn(lo.y, c[1]), __fsub_rn(c[1], hi.x));
        const float gz = gap(__fsub_rn(lo.z, c[2]), __fsub_rn(c[2], hi.y));
        const float pb2 = sum3_sq(gx, gy, gz);
        const float rr = __fadd_rn(__fadd_rn(r, hi.z), kSlack);
        const float margin = __fsub_rn(__fmul_rn(rr, rr), pb2);
        bits |= (margin >= 0.0f ? 1u : 0u) << g;
      }
      bits = __reduce_or_sync(0xffffffffu, bits);
      if (lane == 0 && bits != 0u) atomicOr(&s_mask[d0 + dd], bits);
    }
  }

  const int start = tmeta[2 * tile];
  const int end = start + tmeta[2 * tile + 1];
  float imin[3], imax[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    imin[k] = boxes.tmin[3 * tile + k];
    imax[k] = boxes.tmax[3 * tile + k];
  }
  const float imaxr = boxes.tmaxr[tile];
  __syncthreads();  // every warp's mask bits are in
  for (int e = a; e < nd; e += kAtomTile) {
    const int j = tile + e - (w - 1);
    float jmin[3] = {0.f, 0.f, 0.f}, jmax[3] = {0.f, 0.f, 0.f}, jmaxr = 0.f;
    if (j >= 0 && j < t) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        jmin[k] = boxes.tmin[3 * j + k];
        jmax[k] = boxes.tmax[3 * j + k];
      }
      jmaxr = boxes.tmaxr[j];
    }
    const float sep2 = sum3_sq(
        gap(__fsub_rn(imin[0], jmax[0]), __fsub_rn(jmin[0], imax[0])),
        gap(__fsub_rn(imin[1], jmax[1]), __fsub_rn(jmin[1], imax[1])),
        gap(__fsub_rn(imin[2], jmax[2]), __fsub_rn(jmin[2], imax[2])));
    const float reach = __fadd_rn(__fadd_rn(imaxr, jmaxr), kSlack);
    const uint32_t mask = s_mask[e];
    const bool act = j >= start && j < end &&
                     sep2 <= __fmul_rn(reach, reach) && mask != 0u;
    s_key[e] = act ? sep2 : INFINITY;
    s_entry[e] = (mask << 16) | static_cast<uint32_t>(j);
    if (act) atomicAdd(&s_count, 1);
  }
  __syncthreads();
  const int nkeep = min(nd, kJlistCap);
  for (int e = a; e < nd; e += kAtomTile) {
    const float key = s_key[e];
    int rank = 0;
    for (int f = 0; f < nd; ++f) {
      const float kf = s_key[f];
      rank += (kf < key || (kf == key && f < e)) ? 1 : 0;
    }
    if (rank < nkeep) s_row[1 + rank] = static_cast<int32_t>(s_entry[e]);
  }
  if (a == 0) s_row[0] = s_count;
  __syncthreads();
  jlist[static_cast<int64_t>(tile) * kJlistRows + a] = s_row[a];
}

bool slots_ok(int m) {
  return m > 0 && m % kAtomTile == 0 && m < (1 << 24);
}

}  // namespace

// Launches dequant_boxes on `stream` without synchronizing.  wire 0 (q13):
// in0 u32 [m], in1 u16 [m], palette f32 [256]; wire 1 (q16): in0 u16
// [4, m]; both with tparams f32 [m/128, 4] (ox, oy, oz, scale), writing
// planes f32 [8, m] and qvalid u8 [m].  wire 2: in0 f32 planes [>= 4, m]
// and in1 qvalid u8 [m], writing neither.  The boxes: gmin, gmax f32
// [m/128, 16, 3], gmaxr [m/128, 16], tmin, tmax [m/128, 3], tmaxr
// [m/128], all null on wires 0 and 1 to write none.  0 < m < 2^24, m % 128
// == 0.  Returns the cudaError_t of the launch (0 = success).
extern "C" int dequant_boxes_launch(int wire, const void* in0,
                                    const void* in1, const void* palette,
                                    const void* tparams, void* planes,
                                    void* qvalid, void* gmin, void* gmax,
                                    void* gmaxr, void* tmin, void* tmax,
                                    void* tmaxr, int m, void* stream) {
  const bool no_boxes = gmin == nullptr;
  if (!slots_ok(m) || wire < kQ13 || wire > kFromPlanes ||
      (no_boxes && wire == kFromPlanes) ||
      no_boxes != (gmax == nullptr) || no_boxes != (gmaxr == nullptr) ||
      no_boxes != (tmin == nullptr) || no_boxes != (tmax == nullptr) ||
      no_boxes != (tmaxr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Boxes boxes{static_cast<float*>(gmin), static_cast<float*>(gmax),
                    static_cast<float*>(gmaxr), static_cast<float*>(tmin),
                    static_cast<float*>(tmax), static_cast<float*>(tmaxr)};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto pal = static_cast<const float*>(palette);
  const auto par = static_cast<const float*>(tparams);
  auto out = static_cast<float*>(planes);
  auto qv = static_cast<uint8_t*>(qvalid);
  const int grid = m / kAtomTile;
  if (wire == kQ13) {
    dequant_boxes_kernel<kQ13><<<grid, kAtomTile, 0, s>>>(
        in0, in1, pal, par, out, qv, boxes, m);
  } else if (wire == kQ16) {
    dequant_boxes_kernel<kQ16><<<grid, kAtomTile, 0, s>>>(
        in0, in1, pal, par, out, qv, boxes, m);
  } else {
    dequant_boxes_kernel<kFromPlanes><<<grid, kAtomTile, 0, s>>>(
        in0, in1, pal, par, out, qv, boxes, m);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches band_jlist on `stream` without synchronizing.  planes f32
// [>= 4, m] (rows x, y, z, r_eff), qvalid u8 [m], tmeta i32 [m/128, 2]
// (first tile of the tile's structure, its tiles), the boxes of
// dequant_boxes; writes jlist i32 [m/128, 128].  0 < m < 2^24, m % 128
// == 0, 1 <= w <= 127.  Returns the cudaError_t of the launch.
extern "C" int band_jlist_launch(const void* planes, const void* qvalid,
                                 const void* tmeta, const void* gmin,
                                 const void* gmax, const void* gmaxr,
                                 const void* tmin, const void* tmax,
                                 const void* tmaxr, void* jlist, int m, int w,
                                 void* stream) {
  if (!slots_ok(m) || w < 1 || w > kMaxW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Boxes boxes{const_cast<float*>(static_cast<const float*>(gmin)),
                    const_cast<float*>(static_cast<const float*>(gmax)),
                    const_cast<float*>(static_cast<const float*>(gmaxr)),
                    const_cast<float*>(static_cast<const float*>(tmin)),
                    const_cast<float*>(static_cast<const float*>(tmax)),
                    const_cast<float*>(static_cast<const float*>(tmaxr))};
  band_jlist_kernel<<<m / kAtomTile, kAtomTile, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const uint8_t*>(qvalid),
      static_cast<const int32_t*>(tmeta), boxes,
      static_cast<int32_t*>(jlist), m, w);
  return static_cast<int>(cudaGetLastError());
}
