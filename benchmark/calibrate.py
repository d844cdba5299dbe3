"""Readings that the limits of ``limits/<cell>.json`` are set from, many
seeds in one process (the benchmark's own runs never run this):

- ``program``: the numbers of sound runs of the program (set-up's first
  steps, or a short window's rollouts, against the reference);
- ``control``: the reference at fp8 in the program's place, against the
  float32 reference;
- a fault planted in the program (``harness.LOOPS``' ``fault``):
  ``unchanged``, ``half_batch``, ``altered`` (rollout cells),
  ``no_exchange`` (cells on several cards: DDP exchanges no gradient).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control 1,2,3] [--faults half_batch:1,2,3;no_exchange:4]

Prints one JSON line per reading. On a cell of several cards the program
and the faults run on as many ranks, started as ``benchmark.run`` starts
them; rank 0 runs the reference and prints. The control alone needs one
card.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark.run import ROOT, _caches, launched, rank_arguments  # noqa: E402


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def _judge(cell, device, kind, what, seed, every, prog_s, loop) -> dict:
    """The line of one reading: ``every`` rank's readings (None for the
    control) against the reference, on ``device``; ``loop``: a rollout
    cell's program, which holds its sample."""
    from benchmark import check, harness

    t = time.perf_counter()
    if what == "control":
        numbers = (harness.train_control if kind == "train"
                   else harness.rollout_control)(cell, seed, device)
        return {"what": what, "seed": seed, "numbers": numbers,
                "seconds": time.perf_counter() - t}
    if kind == "train":
        got = every[0]
        ref = harness.reference_train_readings(cell, seed, device)
        numbers = check.worst([check.train_numbers(g, ref) for g in every])
        extra = {"losses": got["losses"], "ref_losses": ref["losses"],
                 "grad_norms": got["grad_norms"], "ref_grad_norms": ref["grad_norms"],
                 "worst": check.worst_names(got, ref),
                 "kept_leaves": len(check.kept_leaves(ref["first_grad_raw"])),
                 "leaves": len(ref["first_grad_raw"])}
    else:
        numbers = loop.reference(seed, every[0])
        extra = {"requests": [i for i, _ in loop.sample]}
    return {"what": what, "seed": seed, "numbers": numbers, "program_s": prog_s,
            "reference_s": time.perf_counter() - t, **extra}


def readings(cell, device, plan, ranks=None) -> None:
    """Print a line for each reading of ``plan`` ((what, seed) pairs), each
    from a program built anew. Across ``ranks`` the plan goes in rounds of
    one reading a rank: every rank runs each program of the round, rank j
    judges the round's j-th reading on its own card, and rank 0 prints."""
    import torch

    from benchmark import harness

    world, rank = (1, 0) if ranks is None else (ranks.world, ranks.rank)
    kind = harness.LOOPS[cell.traffic["loop"]].kind
    for first in range(0, len(plan), world):
        mine = None
        for j, (what, seed) in enumerate(plan[first:first + world]):
            if what == "control":
                if j == rank:
                    mine = (what, seed, None, None, None)
                continue
            loop = harness.LOOPS[cell.traffic["loop"]](cell, device,
                                                       None if what == "program" else what)
            t = time.perf_counter()
            loop.load(seed)
            got = loop.warm(seed)
            if kind == "rollout":
                harness.window(loop, 2.0, False)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            prog_s = time.perf_counter() - t
            every = [got] if ranks is None else ranks.gather(got, dst=j)
            if kind == "train":
                loop.free()
                loop = None
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
            if j == rank:
                mine = (what, seed, every, prog_s, loop)
            del loop
        line = _judge(cell, device, kind, *mine) if mine is not None else None
        lines = [line] if ranks is None else ranks.gather(line)
        for line in lines or ():
            if line is not None:
                print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="", help="name:seed,seed;name:seed")
    rank_arguments(ap)
    args = ap.parse_args(argv)
    if args.rank is not None:
        from benchmark import ranks

        ranks.pin(args.cores)
    _caches()
    import torch

    from benchmark import spec

    cell = spec.load_cell(args.workload, ROOT)
    plan = [("program", s) for s in _seeds(args.seeds)]
    plan += [("control", s) for s in _seeds(args.control)]
    for part in filter(None, args.faults.split(";")):
        name, seeds = part.split(":")
        plan += [(name, s) for s in _seeds(seeds)]
    ranked = cell.chips > 1 and any(what != "control" for what, _ in plan)
    if ranked and args.rank is None:
        return launched("benchmark.calibrate", argv, cell.chips)
    group = None
    if args.rank is None:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        from benchmark import ranks

        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
        group = ranks.start(args.rank, cell.chips, args.port, device)
    readings(cell, device, plan, group)
    if group is None or group.rank == 0:
        print(json.dumps({"what": "done", "seconds": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    if "--rank" not in sys.argv:
        sys.exit(main())
    from benchmark import ranks

    ranks.run_rank(main)
