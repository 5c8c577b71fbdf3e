"""How fast the kernel experiments' margin loops can run, on the card.

    python -m rustsasa_tpu_torch.scripts.loop_ceiling

The bounds in chip_smoke.py count every margin instruction at the FP32
issue peak (33.5T/s: 132 SMs x 128 lanes x 1.98 GHz).  This study times
the inner row loops of csrc/ke_maxplus.cu and csrc/ke_bf16.cu alone, with
their thread layouts and shared-memory reads but no prologue, products or
barriers, on data staged once, and the same loops with one instruction
swapped, so that the ceiling each loop can reach and what sets it show:

  * maxplus: occ = max(occ, x + lim), FADD + FMNMX a margin (512 threads
    of 8 points x 4 atoms, per row 3 LDS.128);
  * maxplus_add: the max replaced by an add, 2 FADD a margin;
  * maxplus_max: the add replaced by a max, 2 FMNMX a margin;
  * bf16: occ = max(occ, lim - (sx*vx + (sy*vy + sz*vz))) on bf16 pairs,
    7 packed instructions a pair (256 threads x 2 CTAs of 8 pairs x 4
    atoms, per row 4 LDS.128);
  * bf16_add: HMNMX2 replaced by HADD2.

Each loop runs 4 waves of CTAs; the rate is the loop's margin
instructions over the kernel time (CUDA events).  The results are not
the kernels' outputs and are thrown away.

Then it times the kernels themselves at T = 512 x NJ = 1,408 on the ones
j-data, built as they are and with one part cut out by a text
substitution that must apply (CUTS; the cut builds compute wrong sums and
exist only to be timed), in turns:

  * nobar: without the barriers between the prologues and the margins;
  * noprologue: without the limits (ke_maxplus) or the group prologue
    (ke_bf16), the margins reading what the first one left.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops import _kernels
from . import _study
from . import kernel_experiments as ke

# FP32 instruction issue peak of chip_smoke.py's bounds.
PEAK_INSTR_PER_S = 33.5e12

SOURCE = r"""
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <int kMode>
__global__ void __launch_bounds__(512, 1) mp_loop(float* out, int reps) {
  extern __shared__ float4 smem[];
  float* lim = reinterpret_cast<float*>(smem);  // [128 rows][128 atoms]
  float* wx = lim + 128 * 128;                  // [16 warps][128 rows][8]
  for (int q = threadIdx.x; q < 2 * 128 * 128; q += 512) {
    lim[q] = (q % 977) * 1e-3f - 0.3f;
  }
  __syncthreads();
  const float* l0 = lim + (threadIdx.x % 32) * 4;
  const float* x0 = wx + (threadIdx.x / 32) * 1024;
  float occ[8][4];
  for (int q = 0; q < 8; ++q)
    for (int k = 0; k < 4; ++k) occ[q][k] = -1e30f;
  for (int it = 0; it < reps; ++it) {
#pragma unroll 8
    for (int r = 0; r < 128; ++r) {
      const float4 l4 = *reinterpret_cast<const float4*>(l0 + r * 128);
      const float4 a = *reinterpret_cast<const float4*>(x0 + r * 8);
      const float4 b = *reinterpret_cast<const float4*>(x0 + r * 8 + 4);
      const float l[4] = {l4.x, l4.y, l4.z, l4.w};
      const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (kMode == 0) {
            occ[q][k] = fmaxf(occ[q][k], __fadd_rn(x[q], l[k]));
          } else if (kMode == 1) {
            occ[q][k] = __fadd_rn(occ[q][k], __fadd_rn(x[q], l[k]));
          } else {
            occ[q][k] = fmaxf(occ[q][k], fmaxf(x[q], l[k]));
          }
        }
    }
  }
  float acc = 0.0f;
  for (int q = 0; q < 8; ++q)
    for (int k = 0; k < 4; ++k) acc += occ[q][k];
  out[blockIdx.x * 512 + threadIdx.x] = acc;
}

template <int kMode>
__global__ void __launch_bounds__(256, 2) bf16_loop(float* out, int reps) {
  extern __shared__ float4 smem[];
  uint32_t* slot = reinterpret_cast<uint32_t*>(smem);  // [8][4][128]
  for (int q = threadIdx.x; q < 8 * 4 * 128; q += 256) {
    const __nv_bfloat162 v = __float2bfloat162_rn((q % 113) * 1e-2f - 0.5f);
    slot[q] = *reinterpret_cast<const uint32_t*>(&v);
  }
  __syncthreads();
  const int a0 = (threadIdx.x % 32) * 4;
  __nv_bfloat162 sx[8], sy[8], sz[8], occ[8][4];
  for (int q = 0; q < 8; ++q) {
    sx[q] = __float2bfloat162_rn(0.1f * q + threadIdx.x * 1e-3f);
    sy[q] = __float2bfloat162_rn(0.2f * q);
    sz[q] = __float2bfloat162_rn(-0.1f * q);
    for (int k = 0; k < 4; ++k) occ[q][k] = __float2bfloat162_rn(-1e30f);
  }
  for (int it = 0; it < reps; ++it) {
#pragma unroll 2
    for (int r = 0; r < 8; ++r) {
      uint4 w[4];
      for (int u = 0; u < 4; ++u) {
        w[u] = *reinterpret_cast<const uint4*>(slot + (r * 4 + u) * 128 + a0);
      }
      const uint32_t* p[4] = {&w[0].x, &w[1].x, &w[2].x, &w[3].x};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const auto h = [&](int u) {
            return *reinterpret_cast<const __nv_bfloat162*>(p[u] + k);
          };
          const __nv_bfloat162 d = __hadd2_rn(
              __hmul2_rn(sx[q], h(1)),
              __hadd2_rn(__hmul2_rn(sy[q], h(2)), __hmul2_rn(sz[q], h(3))));
          occ[q][k] = kMode == 0 ? __hmax2(occ[q][k], __hsub2_rn(h(0), d))
                                 : __hadd2_rn(occ[q][k], __hsub2_rn(h(0), d));
        }
    }
  }
  float acc = 0.0f;
  for (int q = 0; q < 8; ++q)
    for (int k = 0; k < 4; ++k) {
      acc += __low2float(occ[q][k]) + __high2float(occ[q][k]);
    }
  out[blockIdx.x * 256 + threadIdx.x] = acc;
}

template <typename Kernel>
int launch(Kernel kernel, int threads, int smem, float* out, int blocks,
           int reps, cudaStream_t stream) {
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<blocks, threads, smem, stream>>>(out, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int loop_ceiling_launch(int loop, void* out, int blocks, int reps,
                                   void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mp = 2 * 128 * 128 * 4;
  switch (loop) {
    case 0: return launch(mp_loop<0>, 512, mp, o, blocks, reps, st);
    case 1: return launch(mp_loop<1>, 512, mp, o, blocks, reps, st);
    case 2: return launch(mp_loop<2>, 512, mp, o, blocks, reps, st);
    case 3: return launch(bf16_loop<0>, 256, 16384, o, blocks, reps, st);
    case 4: return launch(bf16_loop<1>, 256, 16384, o, blocks, reps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
"""

# (name, threads a CTA, CTAs a SM, margin instructions a thread and rep,
# reps): 128 rows x 32 margins x 2, or 8 rows x 32 pairs x 7 packed.
LOOPS = (
    ("maxplus", 512, 1, 128 * 64, 200),
    ("maxplus_add", 512, 1, 128 * 64, 200),
    ("maxplus_max", 512, 1, 128 * 64, 200),
    ("bf16", 256, 2, 8 * 224, 1600),
    ("bf16_add", 256, 2, 8 * 224, 1600),
)


# Kernel source -> [(tag, [(text, replacement), ...])]: its cut builds.
CUTS = {
    "ke_maxplus": (
        ("full", []),
        ("nobar", [
            ("if (t > 0 && !kSat) __syncthreads();", ""),
            ("__syncthreads();  // the tile's limits and votes are published",
             "")]),
        ("noprologue", [
            ("const bool hit = group_limits(s.irec, tile, lim, warp, a0);",
             "const bool hit = true;")]),
    ),
    "ke_bf16": (
        ("full", []),
        ("nobar", [("hit = __syncthreads_or(next) != 0;",
                    "hit = next || true;")]),
        ("noprologue", [
            ("const bool next = g + 1 < n_groups && prologue(g + 1);",
             "const bool next = true;")]),
    ),
}
# The variants timed per source.
CUT_VARIANTS = {"ke_maxplus": ("mp_tile_hi", "mp_group_hi", "mp_group_def"),
                "ke_bf16": ("g8_bf16",)}


def run_cuts(device, *, reps: int = 10) -> dict[str, dict[str, float]]:
    """{variant: {tag: best warm ms}} of each cut build at the script's
    T x NJ on its ones j-data, timed in turns (full, cuts, then back)."""
    sphere, planes, jd = ke.synthetic_inputs(ke.T, ke.NJ, device)
    m = planes.shape[1]
    out = torch.empty(m, dtype=torch.float32, device=device)
    executed = torch.empty(m // ke.A, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    result = {}
    for name in CUTS:
        fns = _kernels.build_sources(
            "loop_ceiling", _kernels.cut_sources(name, CUTS[name]),
            f"{name}_launch", _kernels._SIGNATURES[name])
        tags = [tag for tag, _ in CUTS[name]]
        for variant in CUT_VARIANTS[name]:
            code = _kernels.KE_VARIANTS[name].index(variant)
            ms = {}
            for tag in tags + tags[::-1]:
                def call(fn=fns[tag]):
                    rc = fn(sphere.data_ptr(), planes.data_ptr(),
                            jd.data_ptr(), out.data_ptr(), executed.data_ptr(),
                            m, ke.NJ, code, stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}_launch: cudaError {rc}")

                _first, best, _ = _study.timed(call, device, reps)
                ms[tag] = min(ms.get(tag, best), best)
            result[variant] = ms
    return result


def run(device) -> dict[str, dict]:
    """{loop: {"ms", "instr_per_s", "of_peak"}} over 4 waves of CTAs."""
    device = torch.device(device)
    fn = _kernels.build_sources(
        "loop_ceiling", {"loops": SOURCE}, "loop_ceiling_launch",
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p])["loops"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.empty(4 * 2 * sms * 512, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    result = {}
    for code, (name, threads, per_sm, instr, reps) in enumerate(LOOPS):
        blocks = 4 * per_sm * sms

        def call(reps=reps, blocks=blocks, code=code, name=name):
            rc = fn(code, out.data_ptr(), blocks, reps, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: cudaError {rc}")

        _first, ms, _ = _study.timed(call, device, 3)
        rate = blocks * threads * reps * instr / (ms * 1e-3)
        result[name] = {"ms": ms, "instr_per_s": rate,
                        "of_peak": rate / PEAK_INSTR_PER_S}
    return result


def main(argv=None) -> int:
    del argv
    if not torch.cuda.is_available():
        print("loop_ceiling: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    for name, v in run(device).items():
        print(f"loop_ceiling {name:12s} {v['ms']:8.3f} ms  "
              f"{v['instr_per_s'] / 1e12:6.2f}T margin instr/s, "
              f"{v['of_peak']:.3f} of {PEAK_INSTR_PER_S / 1e12:.1f}T on "
              f"{_study.device_name(device)}", flush=True)
    for variant, ms in run_cuts(device).items():
        print(f"loop_ceiling {variant} at T={ke.T} x NJ={ke.NJ}: "
              + ", ".join(f"{tag} {v:.3f} ms" for tag, v in ms.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
