"""The device trace of a few steps: torch.profiler over CPU and CUDA,
exported and read back as a Chrome trace. From it: every device operation
(kernels, copies, memsets) with its duration, the seconds in which any of
them ran (the union of their intervals), the traced window's length, and
the longest gaps with no device operation, each named by what the host was
doing at its middle (the benchmark's own labels, then the innermost
operator)."""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile(step: Callable[[], None], n_steps: int, tmpdir: str) -> Dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    return summarize(events, n_steps, wall)


def summarize(events: List[dict], n_steps: int, wall_s: float) -> Dict:
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels = [(e.get("name", ""), float(e.get("dur", 0.0)) * 1e-6)
               for e in dev if e.get("cat") == "kernel"]
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev]
    busy_s = _union(intervals) * 1e-6
    by_name: Dict[str, float] = {}
    for e in dev:
        name = e.get("name", "")[:96]
        by_name[name] = by_name.get(name, 0.0) + float(e.get("dur", 0.0)) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(n_steps=n_steps, window_s=wall_s, busy_s=busy_s, kernels=kernels,
                device_ops=[[k, v] for k, v in top],
                idle_gaps=_idle_gaps(events, intervals))


def _idle_gaps(events, intervals, top: int = 10):
    """The longest gaps between device operations, each named by the
    benchmark's label and the innermost host operator at its middle."""
    if not intervals:
        return []
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:top]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation", "python_function")]
    out = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        over = [h for h in host if float(h["ts"]) <= mid <= float(h["ts"]) + float(h.get("dur", 0))]
        label = next((h["name"] for h in sorted(over, key=lambda h: float(h["ts"]))
                      if h.get("cat") == "user_annotation" and h["name"].startswith("bench.")),
                     "no label")
        ops = [h for h in over if h.get("cat") == "cpu_op"]
        inner = max(ops, key=lambda h: float(h["ts"]))["name"] if ops else "no operator"
        out.append([f"{label} / {inner}"[:120], length * 1e-6])
    return out


def kernel_seconds(profile_: Dict, patterns) -> float:
    """Summed device seconds of the traced kernels whose name matches any
    of the regular expressions `patterns`."""
    import re
    regs = [re.compile(p) for p in patterns]
    return sum(d for name, d in profile_["kernels"] if any(r.search(name) for r in regs))

