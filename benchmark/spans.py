"""The port's spans (``poseidon_tpu_torch/tracing.py``) in the profiler's
Chrome trace, reduced per call to device time, idle gaps and launches
charged to the train step's phases and the Swin block's parts.

A device op (a ``kernel``, ``gpu_memcpy`` or ``gpu_memset`` event) is
found at its launch, the ``cuda_runtime`` or ``cuda_driver`` event with its
``correlation``, and charged:

- to a phase: the ``scot.forward``, ``scot.backward`` or ``scot.optimizer``
  span whose interval holds the launch, on any thread (autograd's device
  thread launches the backward while the main thread is inside
  ``scot.backward``);
- to a part: the innermost ``scot.block.*`` span around the launch on its
  thread; else, for a launch inside a backward op, the part around that
  op's forward op, which the profiler links to it by sequence number and
  forward thread (their ``fwdbwd`` flow);
- to a call: the ``scot.train_step`` or ``scot.rollout`` span whose
  interval holds the launch.

Idle gaps are all the holes between the device's busy intervals, each
charged to the phase span that holds its middle, else to "between calls".
What no span claims is kept under "none".

    python3 -m benchmark.spans --workload <cell> --seed <n> [--seconds <s>]

on a card runs the cell's set-up and a window as ``benchmark.run`` does,
profiles the traffic's ``profile_calls`` calls, and prints one JSON line:
the span figures under the names of the per-layer metrics they feed, their
checks, and the profiled and window calls' walls.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .counts import BF16, FP32, blocks, bound_s
from .kernels import group_of
from .reference.scot import stage_geometry
from .trace import DEVICE_CATS, _union

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# What a launch's CUDA runtime or driver API call is named: kernel (and graph)
# launches, copies, fills.
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")
CALLS = ("scot.train_step", "scot.rollout")
PHASES = ("forward", "backward", "optimizer")
BLOCK = "scot.block."
NONE = "none"
BETWEEN = "between calls"


def _intervals(events: List[dict], names) -> List[Tuple[float, float, str]]:
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"] in names)


def _holder(intervals: List[Tuple[float, float, str]], starts: List[float],
            t: float) -> Optional[int]:
    """Index of the interval holding ``t`` (the intervals do not overlap),
    or None."""
    k = bisect.bisect_right(starts, t) - 1
    return k if k >= 0 and t <= intervals[k][1] else None


def _launch_parts(events: List[dict]) -> Dict[int, Tuple[float, Optional[str]]]:
    """correlation -> (time, part) of every launch in the trace: a runtime
    or driver API call that starts a kernel, a graph, a copy or a fill."""
    flow_id, flow_start = {}, {}
    for e in events:
        if e.get("cat") == "fwdbwd":
            key = (e.get("pid"), e.get("tid"), e["ts"])
            if e.get("ph") == "f":
                flow_id[key] = e["id"]
            elif e.get("ph") == "s":
                flow_start[e["id"]] = key
    threads = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation") + LAUNCH_CATS:
            threads[(e.get("pid"), e.get("tid"))].append(e)
    op_part: Dict[tuple, Optional[str]] = {}
    launches: Dict[int, Tuple[float, Optional[str], Optional[tuple]]] = {}
    for (pid, tid), evs in threads.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        # Each entry: (end, innermost part, innermost backward op linked to
        # its forward op) of an open range and the ranges around it.
        stack: List[Tuple[float, Optional[str], Optional[tuple]]] = []
        for e in evs:
            while stack and stack[-1][0] <= e["ts"]:
                stack.pop()
            part, link = stack[-1][1:] if stack else (None, None)
            key = (pid, tid, e["ts"])
            cat = e["cat"]
            if cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None and any(w in e["name"] for w in LAUNCH_WORDS):
                    launches[corr] = (e["ts"], part, link)
                continue
            if cat == "user_annotation" and e["name"].startswith(BLOCK):
                part = e["name"][len(BLOCK):]
            elif cat == "cpu_op":
                op_part[key] = part
                if key in flow_id:
                    link = key
            stack.append((e["ts"] + e["dur"], part, link))
    out = {}
    for corr, (ts, part, link) in launches.items():
        if part is None and link is not None:
            part = op_part.get(flow_start.get(flow_id[link]))
        out[corr] = (ts, part)
    return out


def reduce_spans(events: List[dict]) -> Optional[dict]:
    """Per call, of a Chrome trace's events (microsecond timestamps):
    ``calls``; ``launches`` (of each call, in order); ``dropped`` (launches,
    in all, whose device op the profiler did not record); ``spans``
    (``scot.*`` ranges a call); ``device_s`` (summed device-op seconds);
    ``phase_device_s`` {phase: s}; ``part_device_s`` {part: {kernel group:
    s}}; ``idle_s`` {phase or "between calls": s}. None when the trace
    holds no call span."""
    calls = _intervals(events, CALLS)
    if not calls:
        return None
    n = len(calls)
    call_starts = [c[0] for c in calls]
    phases = _intervals(events, {"scot." + p for p in PHASES})
    phase_starts = [p[0] for p in phases]

    def phase_of(t: float) -> Optional[str]:
        k = _holder(phases, phase_starts, t)
        return None if k is None else phases[k][2][len("scot."):]

    launch = _launch_parts(events)
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    per_call = [0] * n
    for ts, _ in launch.values():
        k = _holder(calls, call_starts, ts)
        if k is not None:
            per_call[k] += 1
    recorded = set()
    phase_s: Dict[str, float] = defaultdict(float)
    part_s: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    total = 0.0
    for e in device:
        s = e["dur"] / 1e6
        total += s
        corr = e.get("args", {}).get("correlation")
        recorded.add(corr)
        found = launch.get(corr)
        ts, part = found if found else (None, None)
        phase = phase_of(ts) if ts is not None else None
        phase_s[phase or NONE] += s
        part_s[part or NONE][group_of(e["name"])] += s
    idle: Dict[str, float] = defaultdict(float)
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    for (_, a), (b, _) in zip(busy, busy[1:]):
        idle[phase_of(0.5 * (a + b)) or BETWEEN] += (b - a) / 1e6
    spans = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"].startswith("scot."))
    dropped = sum(1 for corr in launch if corr not in recorded)
    return {"calls": n, "launches": per_call, "dropped": dropped, "spans": spans / n,
            "device_s": total / n,
            "phase_device_s": {k: v / n for k, v in phase_s.items()},
            "part_device_s": {p: {g: v / n for g, v in gs.items()} for p, gs in part_s.items()},
            "idle_s": {k: v / n for k, v in idle.items()}}


def mlp_s(model: dict, batch: int, backward: bool) -> float:
    """Least time of every block's MLP at ``batch`` images: the forward's
    two products of 2 M C F (reads the tokens, both weights and biases;
    writes the output), plus with ``backward`` twice the operations (reads
    the tokens, the output's gradient and both weights; writes the tokens'
    gradient and the weights' and biases' gradients); bf16 activations,
    fp32 weights."""
    total = 0.0
    for stage, _ in blocks(model):
        res, dim, _, _ = stage_geometry(model, stage)
        m, f = batch * res * res, int(model["mlp_ratio"] * dim)
        flops = 4.0 * m * dim * f
        params = (2 * dim * f + f + dim) * FP32
        total += bound_s(flops, 2 * m * dim * BF16 + params)
        if backward:
            total += bound_s(2.0 * flops, 3 * m * dim * BF16 + 2 * dim * f * FP32 + params)
    return total


def figures(spans: Optional[dict], kind: str, model: dict, batch: int,
            ar_steps: int = 1) -> Dict[str, float]:
    """The span metrics of a cell of ``kind`` ("train" or "rollout") by
    name, from :func:`reduce_spans`; empty without spans."""
    if not spans:
        return {}
    parts = spans["part_device_s"]
    attention = parts.get("attention", {})
    mlp = sum(parts.get("mlp", {}).values())
    out = {"norm_device_ms": 1e3 * sum(parts.get("norm", {}).values()),
           "attention_other_device_ms":
               1e3 * (sum(attention.values()) - attention.get("attention", 0.0)),
           "launches": sum(spans["launches"]) / spans["calls"]}
    if mlp > 0:
        out["mlp_roofline"] = 100.0 * ar_steps * mlp_s(model, batch, kind == "train") / mlp
    if kind == "train":
        for p in PHASES:
            out[f"{p}_device_ms"] = 1e3 * spans["phase_device_s"].get(p, 0.0)
            out[f"{p}_idle_ms"] = 1e3 * spans["idle_s"].get(p, 0.0)
    return {f"{k}.{kind}": v for k, v in out.items()}


def checks(spans: dict) -> Dict[str, Optional[float]]:
    """The share of a call's device-op time charged to the three phases, and
    the shares of the attention and MLP kernel groups' time charged to their
    own parts."""
    parts = spans["part_device_s"]
    whole = spans["device_s"]

    def group_share(group: str, part: str) -> Optional[float]:
        total = sum(gs.get(group, 0.0) for gs in parts.values())
        return parts.get(part, {}).get(group, 0.0) / total if total > 0 else None

    phased = sum(spans["phase_device_s"].get(p, 0.0) for p in PHASES)
    return {"phase_share": phased / whole if whole > 0 else None,
            "attention_in_part": group_share("attention", "attention"),
            "mlp_in_part": group_share("mlp", "mlp")}


def profile_events(call, calls: int, device) -> Tuple[float, List[dict]]:
    """Wall seconds and Chrome trace events of ``calls`` calls under
    torch.profiler (host and device), ending on a synchronize."""
    import torch
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
            return wall, json.load(fh)["traceEvents"]


def main(argv=None) -> int:
    import argparse
    import sys

    import torch

    from . import harness, spec, trace
    from .run import power_limit

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    loop = harness.LOOPS[cell.traffic["loop"]](cell, device)
    loop.load(args.seed)
    loop.warm(args.seed)
    win_s, calls, _, _ = harness.window(loop, args.seconds, False)
    n = cell.traffic["profile_calls"]
    start = loop.start + calls
    wall, events = profile_events(lambda i: loop.call(start + i), n, device)
    red = trace.reduce_trace(events)
    spans = reduce_spans(events)
    model = cell.config["model"]
    line = {"workload": cell.name, "seed": args.seed,
            "device": torch.cuda.get_device_name(device), "power_limit": power_limit(),
            "window_call_ms": 1e3 * win_s / calls, "profiled_call_ms": 1e3 * wall / n,
            "busy_ms": 1e3 * red["busy_s"] / n,
            "figures": figures(spans, loop.kind, model, cell.traffic["batch"],
                               cell.traffic.get("ar_steps", 1)),
            "checks": checks(spans) if spans else None, "spans": spans}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
