#!/usr/bin/env python3
"""Time the window-attention backward kernel (``window_attention_bwd``) at
every attention block of ScOT-B, ScOT-L and ScOT-T at batch 32 and at the
bench's batches (ScOT-B 128, ScOT-L 64), for the port in this checkout or
in another one, so that two versions are timed in one run on one card:

    python3 bench_attention_bwd.py [--root DIR] [--tag NAME] > out.jsonl

``--root DIR``: the root of another checkout (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory); its package and
its ``chip_smoke.py`` helpers are imported instead of this one's, and its
kernels build into its own ``build/kernels``. Inputs as ``chip_smoke.py``'s
``attention_case``, seeded per shape. One JSON line a shape: the kernel's
device ms (torch.profiler, mean of 10 calls after a warm-up cycle), its ms
by CUDA events (median of 20 after 3 warm-ups) and the plan where the
checkout has one (``bwd_plan``); then one line with the card's name and
power limit and, per model at batch 32, the device ms of a train step's 64
launches (8 at stage 0 unshifted and shifted, 16 at each other stage).
Exits 1 without printing results when CUDA is absent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

STEP_LAUNCHES = {"stage0": 8, "stage0_shifted": 8, "stage1": 16, "stage2": 16, "stage3": 16}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None, help="root of the checkout to time")
    ap.add_argument("--tag", default="this", help="name of the version in the output")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("bench_attention_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import poseidon_tpu_torch as pt
    from poseidon_tpu_torch.models import attention as attn_mod
    from poseidon_tpu_torch.ops import window_attention as wa

    sums = {}
    for name, batches in (("B", (32, 128)), ("L", (32, 64)), ("T", (32,))):
        cfg = pt.make_config(name, image_size=128, num_channels=4, num_out_channels=4)
        for batch in batches:
            for k, (tag, n, t, heads, d, nw, window, res, shift) in enumerate(
                    cs.attention_shapes(cfg, batch)):
                gen = torch.Generator().manual_seed(100 + k)
                qkv, qb, bm, scale = cs.attention_case(attn_mod, n, t, heads, d, nw, window,
                                                       res, shift, gen)
                do = torch.randn(n, t, heads * d, generator=gen).to("cuda", torch.bfloat16)

                def fn():
                    return wa.window_attention_bwd(qkv, qb, bm, scale, heads, do)

                dev = cs.device_ms(fn)
                row = {"tag": args.tag, "model": name, "batch": batch, "stage": tag,
                       "shape": f"windows={n} T={t} H={heads} D={d} nW={nw}",
                       "device_ms": dev, "ms": cs.cuda_ms(fn)}
                if hasattr(wa, "bwd_plan"):
                    row["plan"] = dict(zip(("P", "G", "ctas"), wa.bwd_plan(n, nw, heads, t)))
                print(json.dumps(row), flush=True)
                if batch == 32 and name in ("B", "L") and dev is not None:
                    sums[name] = sums.get(name, 0.0) + STEP_LAUNCHES[tag] * dev
                del qkv, do
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()
    print(json.dumps({"tag": args.tag, "card": card[torch.cuda.current_device()],
                      "step_launches_device_ms_b32": sums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
