"""Where the DEFAULT matrix-unit dots spend their time, on the card.

    python -m rustsasa_tpu_torch.scripts.mxu_overlap

csrc/ke_mxu.cu's mxu_dots_def runs two kinds of work per j-row: the
products on the tensor cores (two wgmma m64n64k16 per warpgroup) and the
FP32 epilogue occ = max(occ, lim - d) on the CUDA cores, designed to
overlap.  This study builds the source three ways and times
mxu_dots_def at the kernel experiments' T = 512 x NJ = 1,408 on their
ones j-data, in turns, with CUDA events:

  * full: the kernel as it is;
  * cuda_cores: the products, their fences and waits taken out (the
    accumulators keep their values), so only the CUDA-core work runs;
  * tensor_cores: the epilogue cut to one margin per product, so the
    tensor-core work, the loads and the prologues run with almost no
    FP32 epilogue beside them;
  * unread: all of both kinds of work, but the epilogue takes its
    margins from occ instead of the products, so no FP32 instruction
    waits for a product.

If the two overlapped, `full` would take about the larger of
cuda_cores and tensor_cores; the study prints all four and that sum.
The cut versions compute wrong sums and exist only to be timed; each is
made from the source by a text substitution that must apply.
"""

from __future__ import annotations

import os
import sys

import torch

from ..ops import _kernels
from . import _study
from . import kernel_experiments as ke

SOURCE = os.path.join(_kernels.CSRC_DIR, "ke_mxu.cu")
_ISSUE = """  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
  wgmma_m64n64(d, a, desc);
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");"""
_WAIT = """  asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(W) : "memory");"""
_EPILOGUE = "  for (int nt = 0; nt < kPartRegs / 4; ++nt) {"
_MARGINS = [f"__fsub_rn({lim}, d[4 * nt + {c}])"
            for c, lim in enumerate(("la", "la", "lb", "lb"))]
# (tag, [(text, replacement), ...]) of each build.
CUTS = (
    ("full", []),
    ("cuda_cores", [(_ISSUE, "  (void)desc;"), (_WAIT, "")]),
    ("tensor_cores", [(_EPILOGUE, "  for (int nt = 0; nt < 1; ++nt) {")]),
    ("unread", [(m, m.replace(f"d[4 * nt + {c}]", f"occ[4 * nt + {3 - c}]"))
                for c, m in enumerate(_MARGINS)]),
)


def run(device, *, t: int = ke.T, nj: int = ke.NJ, reps: int = 10):
    """{tag: best warm ms} of mxu_dots_def per build, timed in turns
    (full, cuda_cores, tensor_cores, unread, then back), the best of both
    turns."""
    device = torch.device(device)
    fns = _kernels.build_sources(
        "mxu_overlap", _kernels.cut_sources("ke_mxu", CUTS), "ke_mxu_launch",
        _kernels._SIGNATURES["ke_mxu"])
    sphere, planes, jd = ke.synthetic_inputs(t, nj, device)
    m = planes.shape[1]
    out = torch.empty(m, dtype=torch.float32, device=device)
    executed = torch.empty(m // ke.A, dtype=torch.int32, device=device)
    code = _kernels.KE_VARIANTS["ke_mxu"].index("mxu_dots_def")

    def call(fn):
        rc = fn(sphere.data_ptr(), planes.data_ptr(), jd.data_ptr(),
                out.data_ptr(), executed.data_ptr(), m, nj, code,
                torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ke_mxu_launch failed: cudaError {rc}")

    ms = {}
    tags = [tag for tag, _ in CUTS]
    for tag in tags + tags[::-1]:
        _first, best, _ = _study.timed(lambda: call(fns[tag]), device, reps)
        ms[tag] = min(ms.get(tag, best), best)
    return ms


def main(argv=None) -> int:
    del argv
    if not torch.cuda.is_available():
        print("mxu_overlap: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    ms = run(device)
    print(f"mxu_overlap: mxu_dots_def at T={ke.T} x NJ={ke.NJ} on "
          f"{_study.device_name(device)}: full {ms['full']:.3f} ms, "
          f"cuda_cores {ms['cuda_cores']:.3f} ms, tensor_cores "
          f"{ms['tensor_cores']:.3f} ms (sum of the two "
          f"{ms['cuda_cores'] + ms['tensor_cores']:.3f} ms), unread "
          f"{ms['unread']:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
