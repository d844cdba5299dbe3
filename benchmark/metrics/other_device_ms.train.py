"""Device milliseconds a train step of everything outside the port's
kernels, the library GEMMs, the convolutions, NCCL and the optimizer: the
elementwise, reduction and copy kernels between them."""

from benchmark.kernels import seconds_by_group


def read(ctx):
    prof = ctx["profile"]
    if ctx["kind"] != "train" or not prof:
        return None
    return 1e3 * seconds_by_group(prof["kernels"]).get("other", 0.0) / prof["calls"]
