"""The yardstick's arithmetic: the card's peaks, the work of a step or a
forward, and the least time of the window-attention work at a
configuration's shapes.

A bound is max(operations / peak, bytes / bandwidth) per call, each input
read once and each output written once. Operations are the function's, not
an implementation's: the forward of attention is 4 T^2 D a window and
head, its backward 8 T^2 D (dP, dV, dQ, dK; the scores recomputed by a
kernel are not counted).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from .reference.scot import stage_geometry

# NVIDIA H100 SXM, data sheet, dense, 700 W.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16, FP32 = 2, 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def blocks(model: dict) -> Iterator[Tuple[int, bool]]:
    """(stage, shifted) of every Swin block, encoder and decoder."""
    for i, depth in enumerate(model["depths"]):
        res, _, _, window = stage_geometry(model, i)
        for j in range(depth):
            shifted = j % 2 == 1 and res > window
            yield i, shifted
            yield i, (depth - 1 - j) % 2 == 1 and res > window


def attention_s(model: dict, batch: int, backward: bool) -> float:
    """Least time of every block's window attention at ``batch`` images:
    the forward (reads q, k and v packed, the bias with the shift mask, the
    q bias and the scale; writes the output), plus with ``backward`` the
    backward (reads q, k, v, the output's gradient, the bias, the q bias
    and the scale; writes their gradients), bf16 activations, fp32 bias."""
    total = 0.0
    for stage, shifted in blocks(model):
        res, dim, heads, window = stage_geometry(model, stage)
        t, d = window * window, dim // heads
        windows = (res // window) ** 2
        n = batch * windows
        slots = windows if shifted else 1
        bias = slots * heads * t * t * FP32
        small = (dim + heads) * FP32
        flops = 4.0 * n * heads * t * t * d
        fwd = n * t * 3 * dim * BF16 + bias + small + n * t * dim * BF16
        total += bound_s(flops, fwd)
        if backward:
            bwd = 2 * n * t * 3 * dim * BF16 + n * t * dim * BF16 + 2 * bias + 2 * small
            total += bound_s(2.0 * flops, bwd)
    return total


def affine(entry: Dict[str, float], batch: int) -> float:
    """A count stored as {"fixed": a, "per_sample": b}: a + b * batch."""
    return entry["fixed"] + entry["per_sample"] * batch


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, _groups, output_mask,
                        out_shape=None) -> int:
    """A convolution's backward: the forward's products for each gradient it
    computes. (torch's own formula counts a grouped convolution's weight
    gradient as a dense one's.)"""
    from torch.utils.flop_counter import conv_flop_count

    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def count_flops(model: dict, batch: int, train: bool) -> int:
    """``FlopCounterMode``'s products and convolutions of the reference's
    forward (and with ``train`` its loss and backward) at ``batch`` images,
    on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.scot import Reference, param_shapes

    dev = torch.device("meta")
    params = {k: torch.empty(s, device=dev, requires_grad=train) for k, s in param_shapes(model)}
    size, cin, cout = model["image_size"], model["num_channels"], model["num_out_channels"]
    x = torch.empty((batch, cin, size, size), device=dev)
    t = torch.empty((batch,), device=dev)
    ref = Reference(model)
    fixed = {torch.ops.aten.convolution_backward: _conv_backward_flop}
    with FlopCounterMode(display=False, custom_mapping=fixed) as counter:
        with torch.set_grad_enabled(train):
            pred = ref.forward(params, x, t)
            if train:
                labels = torch.empty((batch, cout, size, size), device=dev)
                norms = ref.label_norms(labels)
                ref.loss(ref.loss_terms(pred, labels, None), norms, batch, labels.shape).backward()
    return counter.get_total_flops()


def affine_count(model: dict, train: bool) -> Dict[str, float]:
    """The count at batch 1 and 2, as {"fixed", "per_sample"}."""
    f1, f2 = count_flops(model, 1, train), count_flops(model, 2, train)
    return {"fixed": float(2 * f1 - f2), "per_sample": float(f2 - f1)}
