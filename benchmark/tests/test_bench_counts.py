"""The yardstick's counts: the frozen FLOP counts of each configuration
recomputed, and the attention bound at a toy shape by hand."""

import json

import pytest

from benchmark import counts
from benchmark.tests.toy import REPO

CONFIGS = sorted((REPO / "benchmark/configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_stored_flop_counts_recomputed(path):
    cfg = json.loads(path.read_text())
    for key, train in (("train_step", True), ("forward", False)):
        got = counts.affine_count(cfg["model"], train)
        assert {k: cfg["flops"][key][k] for k in got} == got


# One stage: a 32x32 image in patches of 4 is 8x8 tokens, windows of 4x4
# (T = 16, four windows), width 8 in 2 heads (D = 4), two blocks, the second
# shifted (the shift mask has a slot a window).
TOY = dict(image_size=32, patch_size=4, embed_dim=8, depths=[2], num_heads=[2],
           window_size=4, mlp_ratio=4.0)
B = 3


def test_attention_bound_by_hand():
    n, t, d, h, c = B * 4, 16, 4, 2, 8
    flops = 4 * n * h * t * t * d
    act = n * t * 3 * c * 2 + n * t * c * 2             # qkv in, out
    small = (c + h) * 4
    unshifted, shifted = h * t * t * 4, 4 * h * t * t * 4
    fwd = [max(flops / 989e12, (act + bias + small) / 3.35e12) for bias in (unshifted, shifted)]
    bwd_act = 2 * n * t * 3 * c * 2 + n * t * c * 2     # qkv, dqkv, do
    bwd = [max(2 * flops / 989e12, (bwd_act + 2 * bias + 2 * small) / 3.35e12)
           for bias in (unshifted, shifted)]
    # Encoder and decoder: each has one unshifted and one shifted block.
    assert counts.attention_s(TOY, B, False) == pytest.approx(2 * sum(fwd), rel=1e-12)
    assert counts.attention_s(TOY, B, True) == pytest.approx(2 * sum(fwd) + 2 * sum(bwd),
                                                             rel=1e-12)
