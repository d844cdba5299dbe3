"""Per cent of one card's bf16 peak: the train step's FLOPs on a card's
batch (the configuration's frozen count of the reference) times the
window's steps, over the window's seconds."""

from benchmark.counts import PEAK_BF16_FLOPS


def read(ctx):
    if ctx["kind"] != "train":
        return None
    w = ctx["window"]
    return 100.0 * ctx["flops_per_call"] * w["calls"] / w["seconds"] / PEAK_BF16_FLOPS
