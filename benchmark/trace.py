"""Reduce a `torch.profiler` Chrome trace to what the per-layer readers
need: the traced window, the device's busy time in it, each kernel's
time, and the longest idle gaps named by the host stage open in them.

The window is the `bench.window` annotation the harness places around
the measured passes.  Device work is every kernel, copy and memset event
(CUPTI activity), clipped to the window; busy time is the length of
their union, so overlapping streams count once.  Host stages are the
`stage.<name>` annotations the harness wraps around the program's own
stage timers; a gap takes the name of the stage on the window's thread
that overlaps it most ("none" where no stage is open).
"""

from __future__ import annotations

import json

WINDOW = "bench.window"
STAGE_PREFIX = "stage."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(a0, a1, b0, b1):
    return max(0.0, min(a1, b1) - max(a0, b0))


def summarize(events, top: int = 10) -> dict | None:
    """{"window_s", "busy_s", "kernel_s", "kernels": {name: s},
    "device_ops": [[name, s]], "idle_gaps": [[stage, s]]} from Chrome
    trace events, or None when the trace holds no window."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w = max(win, key=lambda e: float(e["dur"]))
    w0 = float(w["ts"])
    w1 = w0 + float(w["dur"])
    device, kernels, ops = [], {}, {}
    kernel_s = 0.0
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(w0, float(e["ts"]))
        b = min(w1, float(e["ts"]) + float(e["dur"]))
        if b <= a:
            continue
        device.append((a, b))
        ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a) * 1e-6
        if e["cat"] == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + (b - a) * 1e-6
            kernel_s += (b - a) * 1e-6
    busy = _union(device)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    stages = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
               e["name"][len(STAGE_PREFIX):]) for e in spans
              if e.get("cat") == "user_annotation"
              and e.get("tid") == w.get("tid")
              and str(e.get("name", "")).startswith(STAGE_PREFIX)]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        best, name = 0.0, "none"
        for s0, s1, s in stages:
            o = _overlap(a, b, s0, s1)
            if o > best:
                best, name = o, s
        named.append([name, (b - a) * 1e-6])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernel_s": kernel_s,
        "kernels": kernels,
        "device_ops": sorted(([k, v] for k, v in ops.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": named,
    }


def load(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
