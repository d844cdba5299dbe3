"""Readings that the limits of ``limits/<cell>.json`` are set from, many
seeds in one process (the benchmark's own runs never run this):

- ``program``: the numbers of sound runs of the program (set-up's first
  steps, or a short window's rollouts, against the reference);
- ``control``: the reference at fp8 in the program's place, against the
  float32 reference;
- a fault planted in the program (``harness.LOOPS``' ``fault``):
  ``unchanged``, ``half_batch``, ``altered`` (rollout cells).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control 1,2,3] [--faults half_batch:1,2,3]

Prints one JSON line per reading.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark.run import ROOT, _caches  # noqa: E402


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def readings(cell, device, plan) -> None:
    import torch

    from benchmark import check, harness

    loop = harness.LOOPS[cell.traffic["loop"]](cell, device)
    for what, seed in plan:
        if what == "control":
            t = time.perf_counter()
            numbers = (harness.train_control if loop.kind == "train"
                       else harness.rollout_control)(cell, seed, device)
            print(json.dumps({"what": what, "seed": seed, "numbers": numbers,
                              "seconds": time.perf_counter() - t}), flush=True)
            continue
        loop.fault = None if what == "program" else what
        t = time.perf_counter()
        loop.load(seed)
        got = loop.warm(seed)
        if loop.kind == "rollout":
            harness.window(loop, 2.0, False)
        torch.cuda.synchronize(device)
        prog_s = time.perf_counter() - t
        t = time.perf_counter()
        if loop.kind == "train":
            ref = harness.reference_train_readings(cell, seed, device)
            numbers = check.train_numbers(got, ref)
            extra = {"losses": got["losses"], "ref_losses": ref["losses"],
                     "grad_norms": got["grad_norms"], "ref_grad_norms": ref["grad_norms"],
                     "worst": check.worst_names(got, ref),
                     "kept_leaves": len(check.kept_leaves(ref["first_grad_raw"])),
                     "leaves": len(ref["first_grad_raw"])}
        else:
            numbers = loop.reference(seed, got)
            extra = {"requests": [i for i, _ in loop.sample]}
        print(json.dumps({"what": what, "seed": seed, "numbers": numbers,
                          "program_s": prog_s, "reference_s": time.perf_counter() - t,
                          **extra}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="", help="name:seed,seed;name:seed")
    args = ap.parse_args(argv)
    _caches()
    import torch

    from benchmark import spec

    cell = spec.load_cell(args.workload, ROOT)
    plan = [("program", s) for s in _seeds(args.seeds)]
    plan += [("control", s) for s in _seeds(args.control)]
    for part in filter(None, args.faults.split(";")):
        name, seeds = part.split(":")
        plan += [(name, s) for s in _seeds(seeds)]
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    readings(cell, device, plan)
    print(json.dumps({"what": "done", "seconds": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
