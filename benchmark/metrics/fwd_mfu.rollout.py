"""Per cent of the card's bf16 peak: a rollout's forwards' FLOPs (the
configuration's frozen count of the reference's forward, times the
autoregressive steps) times the window's rollouts, over its seconds."""

from benchmark.counts import PEAK_BF16_FLOPS


def read(ctx):
    if ctx["kind"] != "rollout":
        return None
    w = ctx["window"]
    return 100.0 * ctx["flops_per_call"] * w["calls"] / w["seconds"] / PEAK_BF16_FLOPS
