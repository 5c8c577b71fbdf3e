#!/usr/bin/env python
"""Component microbenchmarks of the port (reference: benches/micro_bench.py,
after the Rust crate's benches/sasa_benchmarks.rs).

    python -m rustsasa_tpu_torch.benches.micro_bench [--device cuda|cpu]

Times the reference's units on example.cif - radius lookup, the native
and Python parsers, atom selection (build_selection at residue level),
`calculate_sasa_internal` on the device and the whole residue-level
`SASAOptions.process` - each the best of `reps` calls after two warm ones
on the host clock (the device units return host arrays, so each call
ends with its readback).  Without CUDA the default device raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

EXAMPLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "data", "pdbs", "example.cif",
)


def timeit(fn, reps=10, warmup=2) -> float:
    """Best milliseconds of `reps` calls of fn() after `warmup` calls."""
    for _ in range(warmup):
        fn()
    best = min(
        (lambda t0=time.perf_counter(): (fn(), time.perf_counter() - t0)[1])()
        for _ in range(reps)
    )
    return best * 1e3


def run(path: str = EXAMPLE, device="cuda") -> dict:
    """{unit name: best ms} for the reference's six units on `path`,
    plus where it ran (cpu_count, gpu_name, power_limit)."""
    from .. import SASAOptions, get_radius, read_structure
    from ..levels import Level, build_selection
    from ..ops.engine import _device, calculate_sasa_internal
    from ..scripts import _study

    dev = _device(device)
    out = {"get_radius (ALA CA)": timeit(lambda: get_radius("ALA", "CA"))}
    structure = read_structure(path)
    out["parse example.cif (native)"] = timeit(lambda: read_structure(path))
    out["parse example.cif (python)"] = timeit(
        lambda: read_structure(path, native=False))
    out["build_atoms_and_mapping"] = timeit(
        lambda: build_selection(structure, Level.RESIDUE))
    sel = build_selection(structure, Level.RESIDUE)
    out["calculate_sasa (device)"] = timeit(
        lambda: calculate_sasa_internal(sel.coords, sel.radii,
                                        group_ids=sel.group_ids,
                                        device=dev),
        reps=5)
    opts = SASAOptions(level=Level.RESIDUE, device=device)
    out["full_sasa_residue_level"] = timeit(lambda: opts.process(structure),
                                            reps=5)
    return {"units_ms": out, **_study.where(dev)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not os.path.exists(EXAMPLE):
        print("example.cif not available", file=sys.stderr)
        return 1
    from ..scripts import _study

    result = run(EXAMPLE, args.device)
    for name, ms in result["units_ms"].items():
        print(f"{name:32s} {ms:10.3f} ms")
    print(_study.where_line(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
