#!/usr/bin/env python3
"""Time the general fused-tail kernels (``mlp_cln_general_fwd`` and
``_bwd``, ``csrc/mlp_cln_general.cu``) at every shape of ``chip_smoke.py``'s
``general_cln_kernel`` phase (ScOT-B, ScOT-L and ScOT-T stages 0-1 in fp32,
ScOT-T with mlp_ratio 3 in bf16, batch 32), for the port in this checkout or
in another one, so that two versions are timed in one run on one card:

    python3 bench_general_tail.py [--root DIR] [--tag NAME] > out.jsonl

``--root DIR``: the root of another checkout (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory); its package and
its ``chip_smoke.py`` helpers are imported instead of this one's, and its
kernels build into its own ``build/kernels``. Inputs as ``chip_smoke.py``'s
``cln_case``, seeded per shape. One JSON line a shape and direction: the
call's device ms (torch.profiler, mean of 10 calls after a warm-up cycle),
its ms by CUDA events (median of 20 after 3 warm-ups), the device kernels a
call (launches in the same profiled calls; null where the checkout's
``device_ms`` does not count them), and the plan where the checkout has one
(``tail_plan``); then one line with the card's name and power limit and
the device ms of a ScOT-B fp32 fused-tail train step's tail launches at
batch 32 (16 forward and 16 backward calls at each of stages 0 and 1).
Exits 1 without printing results when CUDA is absent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

STEP_CALLS = 16  # tail calls of each direction a ScOT-B step makes at each of stages 0 and 1


def profiled(cs, fn):
    """``chip_smoke.device_ms(fn, by_kernel=True)`` of the checkout timed:
    (ms, ms by kernel, launches by kernel a call), the launches None where
    that checkout's helper does not count them."""
    res = cs.device_ms(fn, by_kernel=True)
    return res if len(res) == 3 else (*res, None)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None, help="root of the checkout to time")
    ap.add_argument("--tag", default="this", help="name of the version in the output")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("bench_general_tail: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import poseidon_tpu_torch as pt
    from poseidon_tpu_torch.ops import mlp as mlp_op

    torch.backends.cuda.matmul.allow_tf32 = False
    eps = 1e-5
    step = 0.0
    for k, (model, tag, b, l, c, f, dt) in enumerate(cs.general_cln_cases(pt, mlp_op)):
        gen = torch.Generator().manual_seed(200 + k)
        x, w1, b1, w2, b2, scale, shift = cs.cln_case(b, l, c, f, gen, dt)
        dy = torch.randn(b, l, c, generator=gen).to("cuda", dt)
        plan = (mlp_op.tail_plan(b * l, c, f, dt) if hasattr(mlp_op, "tail_plan") else None)
        calls = (("fwd", lambda: mlp_op.mlp_cln(x, w1, b1, w2, b2, scale, shift, eps)),
                 ("bwd", lambda: mlp_op.mlp_cln_bwd(x, w1, b1, w2, b2, scale, eps, dy)))
        for direction, fn in calls:
            dev, _, launches = profiled(cs, fn)
            row = {"tag": args.tag, "model": model, "stage": tag, "direction": direction,
                   "shape": f"B={b} L={l} C={c} F={f} {str(dt).split('.')[-1]}",
                   "device_ms": dev, "ms": cs.cuda_ms(fn),
                   "kernels": None if launches is None else sum(launches.values())}
            if plan is not None:
                row["plan"] = plan[direction]
            print(json.dumps(row), flush=True)
            if model == "B-fp32" and dev is not None:
                step += STEP_CALLS * dev
        del x, dy
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()
    print(json.dumps({"tag": args.tag, "card": card[torch.cuda.current_device()],
                      "scot_b_fp32_step_tail_device_ms_b32": step}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
