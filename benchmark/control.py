"""The control of `correct`: the plain reference computed in a lower
precision, put in the program's place and judged as a run's answers are.
bfloat16 by default: the program computes in float32 on coordinates
quantized to 13 bits of each structure's extent, and bfloat16's 8
significant bits are the nearest standard format below that grid
(float16's 11 fall between a 13- and a 12-bit grid; PERF.md gives both
readings).

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...] \\
        [--program] [--dtype bfloat16|float16]

For each seed it makes the cell's inputs at the cell's own size and
prints one JSON line: the numbers the cell compares for the control,
and with `--program` also for one pass of the program after its warm-up
(a sound run's readings, several seeds in one process).  The limits in
`workloads/<name>.json` are set between the two (PERF.md gives the
readings).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def readings(workload, seed, *, program, device="cuda", spec=None,
             workdir=None, dtype="bfloat16"):
    import torch

    from . import run

    spec = spec or run.cell_spec(workload)
    workdir = workdir or os.path.join(run.WORK_ROOT, workload)
    runner = run.make_runner(spec, seed, workdir, device)
    out = {"seed": seed, "dtype": dtype}
    if program:
        runner.setup()
        runner.run_pass()
        runner.release()
        answers = runner.answers()
    else:
        runner.make_inputs()
    ref = runner.reference(torch.float64, device)
    low = runner.reference(getattr(torch, dtype), device)
    out["control"] = runner.compare(low, ref)[0]
    if program:
        out["program"] = runner.compare(answers, ref)[0]
    runner.cleanup()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--dtype", choices=("bfloat16", "float16"),
                   default="bfloat16")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        got = readings(args.workload, seed, program=args.program,
                       dtype=args.dtype)
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
