"""Per cent of its roofline: the least time of every block's window
attention at the cell's shapes (forward and backward; counts.attention_s)
over the device time of the attention kernels in a profiled call. Nothing
when no attention kernel ran."""

from benchmark.counts import attention_s
from benchmark.kernels import seconds_by_group


def read(ctx):
    prof = ctx["profile"]
    if ctx["kind"] != "train" or not prof:
        return None
    spent = seconds_by_group(prof["kernels"]).get("attention", 0.0) / prof["calls"]
    if spent <= 0:
        return None
    calls = ctx["traffic"].get("ar_steps", 1)
    return 100.0 * calls * attention_s(ctx["config"]["model"], ctx["batch"], True) / spent
