"""The profiler's trace of a few calls, reduced to what the per-layer
metrics and the breakdown read: device seconds by kernel name, the union of
device activity (busy), and the idle gaps between device operations, each
labelled with the innermost host operation running at its middle."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def profile(call: Callable[[int], object], calls: int, device) -> dict:
    """torch.profiler (host and device) over ``calls`` calls of ``call``,
    ending on a synchronize. Returns the wall seconds of the profiled calls
    and the reduction of their trace (:func:`reduce_trace`)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            call(i)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    out = reduce_trace(events)
    out["wall_s"] = wall
    out["calls"] = calls
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def reduce_trace(events: List[dict]) -> dict:
    """{"kernels": {name: seconds}, "busy_s", "gaps": [[label, seconds]]}
    of a Chrome trace's events (microsecond timestamps)."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels: Dict[str, float] = {}
    for e in device:
        kernels[e["name"]] = kernels.get(e["name"], 0.0) + e["dur"] / 1e6
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "cpu_op")
    starts = [o[0] for o in ops]
    gaps: Dict[str, float] = {}
    holes = sorted(((b0 - a1, a1, b0) for (_, a1), (b0, _) in zip(busy, busy[1:])),
                   reverse=True)
    for length, a, b in holes[:500]:
        mid = 0.5 * (a + b)
        label = "python, between ops"
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if ops[k][1] >= mid:
                label = ops[k][2]
                break
        gaps[label] = gaps.get(label, 0.0) + length / 1e6
    return {"kernels": kernels, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "gaps": sorted(gaps.items(), key=lambda kv: -kv[1])}


def top(pairs, n: int = TOP) -> List[list]:
    return [[name[:160], float(s)] for name, s in sorted(pairs, key=lambda kv: -kv[1])[:n]]
