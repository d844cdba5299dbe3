"""Device milliseconds a train step of NCCL's kernels (``kernels.py``'s
``nccl`` group) in rank 0's profiled calls: the gradient buckets' and the
loss's all-reduces, with the time a kernel sits on the card waiting for
the slowest rank. Nothing when no NCCL kernel ran."""

from benchmark.kernels import seconds_by_group


def read(ctx):
    prof = ctx["profile"]
    if ctx["kind"] != "train" or not prof:
        return None
    spent = seconds_by_group(prof["kernels"]).get("nccl", 0.0)
    if spent <= 0:
        return None
    return 1e3 * spent / prof["calls"]
