"""The port's CUDA kernels against their plain PyTorch versions on the card
(bf16, allclose atol = rtol = 3e-2: only rounding-order flips differ).
They need a CUDA card and skip without one. This file imports neither JAX
nor the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from poseidon_tpu_torch.models.attention import shifted_window_mask
from poseidon_tpu_torch.ops import mlp as mlp_op
from poseidon_tpu_torch.ops import window_attention as wa

TOL = 3e-2


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _close(out, ref):
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,d,shifted", [(16, 24, 32, False), (64, 12, 32, False),
                                           (256, 3, 32, True), (256, 3, 64, False),
                                           (16, 24, 64, False)])
def test_window_attention_kernel_matches_plain(t, h, d, shifted):
    _needs_card()
    g = torch.Generator().manual_seed(0)
    window = int(t ** 0.5)
    nw = 4 if shifted else 1
    n = 3 * nw  # three images
    c = h * d
    qkv = torch.randn(n, t, 3 * c, generator=g).to("cuda", torch.bfloat16)
    qb = (0.1 * torch.randn(c, generator=g)).cuda()
    bm = (16 * torch.sigmoid(torch.randn(h, t, t, generator=g)))[None]
    if shifted:
        bm = bm + 2.0 * torch.from_numpy(
            shifted_window_mask(2 * window, 2 * window, window, window // 2))[:, None]
    bm = bm.contiguous().cuda()
    scale = torch.full((h,), 10.0).cuda()
    before = wa.window_attention.launches
    out = wa.window_attention(qkv, qb, bm, scale, h)
    assert wa.window_attention.launches == before + 1
    _close(out, wa.window_attention_plain(qkv, qb, bm, scale, h))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(1000, 96), (512, 192), (300, 384), (64, 96)])
def test_mlp_kernel_matches_plain(m, c):
    _needs_card()
    g = torch.Generator().manual_seed(1)
    f = 4 * c
    x = torch.randn(m, c, generator=g).to("cuda", torch.bfloat16)
    w1 = (torch.randn(f, c, generator=g) / c ** 0.5).to("cuda", torch.bfloat16)
    w2 = (torch.randn(c, f, generator=g) / f ** 0.5).to("cuda", torch.bfloat16)
    b1 = (0.1 * torch.randn(f, generator=g)).cuda()
    b2 = (0.1 * torch.randn(c, generator=g)).cuda()
    before = mlp_op.mlp.launches
    out = mlp_op.mlp(x, w1, b1, w2, b2)
    assert mlp_op.mlp.launches == before + 1
    _close(out, mlp_op.mlp_plain(x, w1, b1, w2, b2))


@pytest.mark.cuda
def test_fp32_on_card_raises():
    _needs_card()
    x = torch.randn(64, 96, device="cuda")
    w1, w2 = torch.randn(384, 96, device="cuda"), torch.randn(96, 384, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mlp_op.mlp(x, w1, torch.zeros(384, device="cuda"), w2, torch.zeros(96, device="cuda"))
