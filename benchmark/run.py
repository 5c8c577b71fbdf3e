"""Run one cell of the benchmark of rustsasa_tpu_torch on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Everything a cell is comes from files the
harness finds by name: its entry in BENCHMARK.json (configuration,
traffic, chips, metrics), the configuration `configs/<config>.json`, the
traffic mix `traffic/<traffic>.json` (whose `runner` names the general
runner of `runners/` that reads it), the correctness limits
`workloads/<cell>.json`, and a reader `metrics/<metric>.py` for each
metric.  So a later change adds a cell, a configuration, a mix or a
metric by adding files and manifest entries.

A run: checks that the card is there (exit 2 with no result otherwise),
makes the inputs from the seed and warms the cell's own shapes up (all
of that is `setup_s`; torch's host pool at one thread, and what set-up
made frozen out of the garbage collector for the window), then runs
whole passes back to back until `--seconds` have passed; the last pass
started runs to its end, and the window's rates are all the work over
all the time up to it.  With `--trace 1` the window runs under
`torch.profiler` and the result holds the per-layer metrics instead of
the end-to-end ones.  After the window
it reads the peak memory, frees the program's state, compares the
window's answers with the plain reference (`reference.py`) and prints,
on standard error and as the result's last key, each compared number
beside its limit; the last line of standard output is the result.  A
run whose process holds jax, jaxlib, flax or the JAX package
rustsasa_tpu exits 3 with no result.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MANIFEST = os.path.join(REPO, "BENCHMARK.json")
WORK_ROOT = os.path.join(REPO, "build", "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "rustsasa_tpu")


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold,
    compared whole (rustsasa_tpu_torch is not rustsasa_tpu)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Context:
    """What the metric readers (`readers.py`) read from one run."""

    def __init__(self, setup_s, window_s, passes, work, stages, trace,
                 geometry):
        self.setup_s = setup_s
        self.window_s = window_s
        self.passes = passes
        self.work = work
        self.stages = stages
        self.trace = trace
        self._geometry = geometry
        self._geometry_value = None

    def geometry(self):
        """(FP32 instructions, bytes) the window's SASA needs, or None."""
        if self._geometry is not None and self._geometry_value is None:
            self._geometry_value = self._geometry()
        return self._geometry_value


def _json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell_spec(name: str, manifest: dict | None = None) -> dict:
    """The cell's manifest entry, configuration, traffic, limits and
    metric lists, resolved from the files named after them."""
    manifest = manifest or _json(MANIFEST)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = _json(os.path.join(REPO, cfg_entry["file"]))
    traffic = _json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    limits = _json(os.path.join(HERE, "workloads", f"{name}.json"))["limits"]

    def mine(metric):
        return name in metric.get("workloads", [name])

    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "limits": limits,
        "end_to_end": [m for m in manifest["end_to_end"] if mine(m)],
        "per_layer": [m for m in manifest["per_layer"] if mine(m)],
    }


def resolve_paths(config: dict) -> dict:
    """The configuration with its data files as paths in the checkout."""
    out = dict(config)
    if "topology" in out:
        out["topology_path"] = os.path.join(REPO, out["topology"])
    if "structures" in out:
        out["structure_paths"] = [os.path.join(REPO, out["data_dir"], s)
                                  for s in out["structures"]]
    return out


def make_runner(spec, seed, workdir, device):
    module = importlib.import_module(
        f"benchmark.runners.{spec['traffic']['runner']}")
    return module.Runner(resolve_paths(spec["config"]), spec["traffic"],
                         seed, workdir, device, say)


def reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


@contextlib.contextmanager
def stage_annotations(torch):
    """Wrap the program's stage timers (`utils.stagestats.stage`) in
    profiler annotations `stage.<name>`, so the trace shows which stage
    the host was in; restored on exit."""
    from rustsasa_tpu_torch.utils import stagestats

    plain = stagestats.stage

    @contextlib.contextmanager
    def annotated(name):
        with torch.profiler.record_function(f"stage.{name}"), plain(name):
            yield

    stagestats.stage = annotated
    try:
        yield stagestats
    finally:
        stagestats.stage = plain


def main(argv=None, *, device="cuda", require_card=True, spec=None,
         workdir=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = spec or cell_spec(args.workload)
    workdir = workdir or os.path.join(WORK_ROOT, args.workload)
    trace = bool(args.trace)
    if trace:
        # Read by the program's stagestats when it is imported.
        os.environ["RUSTSASA_TPU_PROFILE"] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(WORK_ROOT, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(WORK_ROOT, "triton")

    import torch

    chips = spec["cell"]["chips"]
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < chips):
        say(f"no result: {args.workload} needs {chips} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} visible")
        return 2
    on_card = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if on_card:
        # One process with few threads: torch's host pool at one thread
        # beside the program's own pack threads.  With the freeze below,
        # the quartile spread of one run's pass times fell from 0.08-0.29
        # to 0.07-0.13 of their median on the H100's 8-core host.
        torch.set_num_threads(1)

    runner = make_runner(spec, args.seed, workdir, device)
    with contextlib.ExitStack() as stack:
        stages = stack.enter_context(stage_annotations(torch)) \
            if trace else None
        runner.setup()
        # What set-up made (imports, inputs) lives through the window:
        # frozen out of the collector, so that a full collection (~0.14 s
        # on that host) does not walk the harness's own heap in the
        # middle of a pass.
        gc.collect()
        gc.freeze()
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - START
        say(f"setup {setup_s:.3f} s")

        prof = None
        if trace:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = stack.enter_context(
                torch.profiler.profile(activities=activities))
            stages.reset()
        done, pass_s = {}, []
        with torch.profiler.record_function("bench.window") if trace \
                else contextlib.nullcontext():
            t0 = t = time.perf_counter()
            while t - t0 < args.seconds:
                for k, v in runner.run_pass().items():
                    done[k] = done.get(k, 0) + v
                if on_card:
                    torch.cuda.synchronize()
                pass_s.append(time.perf_counter() - t)
                t += pass_s[-1]
            window_s = t - t0
        gc.unfreeze()
        stage_totals = dict(stages.totals) if trace else None
    passes = len(pass_s)
    say(f"window {window_s:.3f} s, {passes} passes, {done}; pass seconds "
        f"{[round(x, 4) for x in pass_s]}")

    leaked = forbidden_modules()
    if leaked:
        say(f"no result: the process holds {leaked}")
        return 3
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    summary = None
    if trace:
        os.makedirs(workdir, exist_ok=True)
        trace_path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(trace_path)
        from . import trace as trace_mod

        summary = trace_mod.summarize(trace_mod.load(trace_path))
        os.remove(trace_path)
    runner.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ctx = Context(setup_s, window_s, passes, done, stage_totals, summary,
                  lambda: runner.window_work(passes, device))
    metrics = {}
    # A number from a run off the card is never written as a device's.
    for m in spec["per_layer" if trace else "end_to_end"] if on_card else ():
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    t_check = time.perf_counter()
    answers = runner.answers()
    t_ref = time.perf_counter()
    ref = runner.reference(torch.float64, device)
    t_cmp = time.perf_counter()
    checks, attempted, failed = runner.compare(answers, ref)
    runner.cleanup()
    say(f"check {time.perf_counter() - t_check:.3f} s (answers "
        f"{t_ref - t_check:.3f}, reference {t_cmp - t_ref:.3f})")

    limits = spec["limits"]
    compared = {}
    for name, limit in limits.items():
        value = checks.get(name, math.inf)
        compared[name] = {"value": value, "limit": limit}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())

    leaked = forbidden_modules()
    if leaked:
        say(f"no result: the process holds {leaked}")
        return 3
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": chips,
        "memory_peak_bytes": int(peak),
    }
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    result = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": metrics,
        "device": dev,
    }
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["bytes_written"] = int(runner.bytes_written)
    result["pass_s"] = pass_s
    result["checks"] = compared
    for name, c in compared.items():
        say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
