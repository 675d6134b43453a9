"""The device trace of a traced run: torch.profiler over the window, reduced
to the device's busy seconds, the device operations that took most time
and the longest idle gaps, each gap named by the host step in progress.

The window and every probe's call are `record_function` ranges named
"kbench.<name>" (kbench/probes.py); in the exported Chrome trace they are
"user_annotation" events on the host's timeline, and kernels, copies and
memsets are the device's. A gap is named by the innermost probe range
around its middle ("kbench.window" alone: between the host's steps).
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME = 160  # a kernel's name is cut to this many characters


def profiler():
    import torch
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(path: str, window: str = "kbench.window") -> Dict:
    """busy_s, window_s, device_ops [[name, s]] and idle_gaps [[step, s]]
    of the trace at `path`, within the range named `window`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, dev = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e.get("name", cat)[:NAME]))
        elif cat == "user_annotation" and e.get("name", "").startswith(
                "kbench."):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          e["name"]))
    wins = [s for s in spans if s[2] == window]
    if wins:
        w0, w1 = min(s[0] for s in wins), max(s[1] for s in wins)
    elif dev:
        w0, w1 = min(d[0] for d in dev), max(d[1] for d in dev)
    else:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [],
                "idle_gaps": []}
    ops: Dict[str, float] = {}
    iv = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
        iv.append((a, b))
    busy = _merge(iv)
    gaps = []
    prev = w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    inner = [s for s in spans if s[2] != window]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = 0.5 * (a + b)
        around = [s for s in inner if s[0] <= mid <= s[1]]
        step = max(around, key=lambda s: s[0])[2] if around else window
        named.append([step, (b - a) * 1e-6])
    top = sorted(ops.items(), key=lambda x: -x[1])[:TOP]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": named}
