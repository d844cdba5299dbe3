"""The benchmark of ``poseidon_tpu_torch`` on NVIDIA H100 cards.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``check``: each number the correctness check
compared, with its limit (also the last lines of standard error). Exits
non-zero, printing no result, without as many CUDA cards as the cell asks
for, or when JAX or the JAX package was loaded.

A cell on several cards runs one process a card (``ranks.py``): this
process starts them with its own arguments and ``--rank``, ``--port``,
``--started`` and ``--cores``, waits for them, and prints what rank 0
printed once every rank has exited 0; if any fails, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "poseidon_tpu")


def _caches() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return out.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def result_line(cell, run: dict, trace: bool, device: dict) -> dict:
    from benchmark import check

    ctx = run["ctx"]
    metrics = {}
    for m in cell.metrics_for(trace):
        value = m.read(ctx)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    correct = check.judge(run["numbers"], cell.limits) and run["failed"] == 0
    line = {"correct": correct, "attempted": run["attempted"], "failed": run["failed"],
            "metrics": metrics, "device": device}
    if trace and ctx["profile"]:
        from benchmark import harness

        line["breakdown"] = harness.breakdown(ctx["profile"])
    line["check"] = {k: {"value": v, "limit": cell.limits[k]}
                     for k, v in check.compared(run["numbers"], cell.limits).items()}
    return line


def rank_arguments(ap: argparse.ArgumentParser) -> None:
    """The arguments a launcher gives each rank it starts (``ranks.py``)."""
    for name, kind in (("--rank", int), ("--port", int), ("--started", float), ("--cores", str)):
        ap.add_argument(name, type=kind, default=None, help=argparse.SUPPRESS)


def launched(module: str, argv: list, world: int) -> int:
    """Run ``module`` with ``argv`` as ``world`` ranks, and pass on what
    they printed (rank 0's standard output last)."""
    from benchmark import ranks

    started = time.time() - (time.perf_counter() - T0)
    code, out, err = ranks.launch(ranks.rank_commands(module, argv, world, started))
    print(err, end="", file=sys.stderr, flush=True)
    found = forbidden_modules()
    if code == 0 and found:
        print(f"loaded in the launcher: {', '.join(found)}", file=sys.stderr)
        code = 3
    if code == 0:
        print(out, end="", flush=True)
    return code


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    rank_arguments(ap)
    args = ap.parse_args(argv)
    if args.rank is not None:
        from benchmark import ranks

        ranks.pin(args.cores)
    _caches()
    from benchmark import spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if cell.chips > 1 and args.rank is None:
        return launched("benchmark.run", argv, cell.chips)
    from benchmark import harness

    trace = bool(args.trace)
    if args.rank is None:
        run = harness.run(cell, args.seed, args.seconds, trace, T0)
    else:
        from benchmark import ranks

        dev = torch.device("cuda", args.rank)
        torch.cuda.set_device(dev)
        group = ranks.start(args.rank, cell.chips, args.port, dev)
        run = harness.run(cell, args.seed, args.seconds, trace, ranks.since(args.started),
                          device=dev, ranks=group)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3
    if run is None:
        return 0
    dev = torch.device("cuda", 0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell.chips,
              "memory_peak_bytes": run["ctx"]["peak_bytes"], "power_limit": power_limit()}
    prof = run["ctx"]["profile"]
    if trace and prof:
        device["busy_s"] = run["busy_s"]
        device["window_s"] = prof["wall_s"]
        print(f"# launches per call of the port's kernels: {json.dumps(run['launches'])}")
    line = result_line(cell, run, trace, device)
    from benchmark import check

    print(f"# every number the check computes: {json.dumps(run['numbers'])}", file=sys.stderr)
    for text in check.lines(run["numbers"], cell.limits):
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    if "--rank" not in sys.argv:
        sys.exit(main())
    from benchmark import ranks

    ranks.run_rank(main)
