"""The port's CUDA kernels against their plain PyTorch versions on the card
(bf16, allclose atol = rtol = 3e-2: only rounding-order flips differ).
Outputs that are sums over many rows or windows (the weight, bias,
position-bias, q-bias and logit-scale gradients) are held by relative L2
<= 1e-2 instead: one-ulp flips of their rounded terms do not cancel in a
sum near zero. Each backward kernel also gives the same bits on two calls
(no atomics), and each autograd Function's backward agrees with autograd of
its plain forward within relative L2 5e-2 per gradient (the two round to
bf16 at different points). They need a CUDA card and skip without one. This file imports neither JAX
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
SUM_TOL = 1e-2
AUTOGRAD_TOL = 5e-2


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _close(out, ref):
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=TOL, rtol=TOL)


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


ATTN_GEOMS = [(16, 24, 32, False), (64, 12, 32, False), (256, 3, 32, True),
              (256, 3, 64, False), (16, 24, 64, False), (64, 12, 64, True),
              (256, 3, 16, True), (64, 12, 16, False), (16, 24, 16, True),
              (49, 4, 32, False), (49, 4, 16, True), (144, 2, 64, True)]


def _attention_inputs(t, h, d, shifted, seed):
    g = torch.Generator().manual_seed(seed)
    window = round(t ** 0.5)
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
    scale = torch.exp(torch.log(torch.tensor(10.0)) + 0.2 * torch.randn(h, generator=g)).cuda()
    do = torch.randn(n, t, c, generator=g).to("cuda", torch.bfloat16)
    return qkv, qb, bm, scale, do


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,d,shifted", ATTN_GEOMS)
def test_window_attention_kernel_matches_plain(t, h, d, shifted):
    _needs_card()
    qkv, qb, bm, scale, _ = _attention_inputs(t, h, d, shifted, 0)
    before = wa.window_attention.launches
    out = wa.window_attention(qkv, qb, bm, scale, h)
    assert wa.window_attention.launches == before + 1
    _close(out, wa.window_attention_plain(qkv, qb, bm, scale, h))


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,d,shifted", ATTN_GEOMS)
def test_window_attention_bwd_kernel_matches_plain(t, h, d, shifted):
    _needs_card()
    qkv, qb, bm, scale, do = _attention_inputs(t, h, d, shifted, 1)
    before = wa.window_attention_bwd.launches
    out = wa.window_attention_bwd(qkv, qb, bm, scale, h, do)
    assert wa.window_attention_bwd.launches == before + 1
    ref = wa.window_attention_bwd_plain(qkv, qb, bm, scale, h, do)
    _close(out[0], ref[0])
    for a, b in zip(out[1:], ref[1:]):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel(a, b) <= SUM_TOL
    again = wa.window_attention_bwd(qkv, qb, bm, scale, h, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again)), "not bit-identical"


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,d,shifted", [(64, 12, 32, True), (256, 3, 32, False)])
def test_window_attention_function_matches_autograd_of_plain(t, h, d, shifted):
    _needs_card()
    qkv, qb, bm, scale, do = _attention_inputs(t, h, d, shifted, 2)
    grads = []
    for fn in (wa.window_attention, wa.window_attention_plain):
        leaves = [a.clone().requires_grad_() for a in (qkv, qb, bm, scale)]
        fn(*leaves, h).backward(do)
        grads.append([a.grad for a in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) <= AUTOGRAD_TOL


MLP_SHAPES = [(1000, 96), (512, 192), (300, 384), (64, 96), (1000, 48), (256, 48)]


def _mlp_inputs(m, c, seed, f=None):
    g = torch.Generator().manual_seed(seed)
    f = f or 4 * c
    x = torch.randn(m, c, generator=g).to("cuda", torch.bfloat16)
    w1 = (torch.randn(f, c, generator=g) / c ** 0.5).to("cuda", torch.bfloat16)
    w2 = (torch.randn(c, f, generator=g) / f ** 0.5).to("cuda", torch.bfloat16)
    b1 = (0.1 * torch.randn(f, generator=g)).cuda()
    b2 = (0.1 * torch.randn(c, generator=g)).cuda()
    dy = torch.randn(m, c, generator=g).to("cuda", torch.bfloat16)
    return x, w1, b1, w2, b2, dy


# F = 4C keeps the weights of C <= 96 resident in shared memory; a wider F
# takes the streamed plan at those widths too.
@pytest.mark.cuda
@pytest.mark.parametrize("m,c,f", [(m, c, None) for m, c in MLP_SHAPES]
                         + [(500, 96, 512), (256, 48, 1024)])
def test_mlp_kernel_matches_plain(m, c, f):
    _needs_card()
    x, w1, b1, w2, b2, _ = _mlp_inputs(m, c, 1, f)
    before = mlp_op.mlp.launches
    out = mlp_op.mlp(x, w1, b1, w2, b2)
    assert mlp_op.mlp.launches == before + 1
    _close(out, mlp_op.mlp_plain(x, w1, b1, w2, b2))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", MLP_SHAPES)
def test_mlp_bwd_kernel_matches_plain(m, c):
    _needs_card()
    x, w1, b1, w2, _, dy = _mlp_inputs(m, c, 2)
    before = mlp_op.mlp_bwd.launches
    out = mlp_op.mlp_bwd(x, w1, b1, w2, dy)
    assert mlp_op.mlp_bwd.launches == before + 1
    ref = mlp_op.mlp_bwd_plain(x, w1, b1, w2, dy)
    _close(out[0], ref[0])
    for a, b in zip(out[1:], ref[1:]):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel(a, b) <= SUM_TOL
    again = mlp_op.mlp_bwd(x, w1, b1, w2, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again)), "not bit-identical"


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(1000, 96), (300, 384)])
def test_mlp_function_matches_autograd_of_plain(m, c):
    _needs_card()
    x, w1, b1, w2, b2, dy = _mlp_inputs(m, c, 3)
    grads = []
    for fn in (mlp_op.mlp, mlp_op.mlp_plain):
        leaves = [a.clone().requires_grad_() for a in (x, w1, b1, w2, b2)]
        fn(*leaves).backward(dy)
        grads.append([a.grad for a in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) <= AUTOGRAD_TOL


@pytest.mark.cuda
def test_fp32_on_card_raises():
    _needs_card()
    x = torch.randn(64, 96, device="cuda")
    w1, w2 = torch.randn(384, 96, device="cuda"), torch.randn(96, 384, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mlp_op.mlp(x, w1, torch.zeros(384, device="cuda"), w2, torch.zeros(96, device="cuda"))


# (B, L, C): ScOT-B stage 0 and 1 blocks (C = 96 at L = 1024, 192 at 256),
# ScOT-L's stage 1 width, one-tile images, a ScOT-T stage 0 block, and (B,
# L, C, F) a hidden width that streams the weights at C = 96.
CLN_SHAPES = [(2, 1024, 96), (3, 256, 192), (2, 256, 384), (4, 64, 96), (2, 1024, 48),
              (2, 256, 96, 512)]


def _cln_inputs(b, l, c, seed, f=None):
    """Scale and shift differ by image and channel, so that a tile that read
    another image's row would disagree."""
    x, w1, b1, w2, b2, dy = _mlp_inputs(b * l, c, seed, f)
    g = torch.Generator().manual_seed(seed + 50)
    scale = (1.0 + 0.5 * torch.randn(b, c, generator=g)).cuda()
    shift = (0.5 * torch.randn(b, c, generator=g)).cuda()
    return x.view(b, l, c), w1, b1, w2, b2, scale, shift, dy.view(b, l, c)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CLN_SHAPES)
def test_mlp_cln_kernel_matches_plain(shape):
    _needs_card()
    b, l, c, *f = shape
    x, w1, b1, w2, b2, scale, shift, _ = _cln_inputs(b, l, c, 4, *f)
    before = mlp_op.mlp_cln.launches
    out = mlp_op.mlp_cln(x, w1, b1, w2, b2, scale, shift)
    assert mlp_op.mlp_cln.launches == before + 1
    _close(out, mlp_op.mlp_cln_plain(x, w1, b1, w2, b2, scale, shift, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CLN_SHAPES)
def test_mlp_cln_bwd_kernel_matches_plain(shape):
    _needs_card()
    b, l, c, *f = shape
    x, w1, b1, w2, b2, scale, _, dy = _cln_inputs(b, l, c, 5, *f)
    args = (x, w1, b1, w2, b2, scale, 1e-5, dy)
    before = mlp_op.mlp_cln_bwd.launches
    out = mlp_op.mlp_cln_bwd(*args)
    assert mlp_op.mlp_cln_bwd.launches == before + 1
    ref = mlp_op.mlp_cln_bwd_plain(*args)
    _close(out[0], ref[0])
    for a, r in zip(out[1:], ref[1:]):
        assert a.shape == r.shape and a.dtype == torch.float32
        assert _rel(a, r) <= SUM_TOL
    again = mlp_op.mlp_cln_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(out, again)), "not bit-identical"


@pytest.mark.cuda
def test_mlp_cln_function_matches_autograd_of_plain():
    _needs_card()
    x, w1, b1, w2, b2, scale, shift, dy = _cln_inputs(2, 256, 96, 6)
    grads = []
    for fn in (mlp_op.mlp_cln, lambda *a: mlp_op.mlp_cln_plain(*a, 1e-5)):
        leaves = [a.clone().requires_grad_() for a in (x, w1, b1, w2, b2, scale, shift)]
        fn(*leaves).backward(dy)
        grads.append([a.grad for a in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) <= AUTOGRAD_TOL


def _separate(qkv, h):
    n, t, c3 = qkv.shape
    return [a.contiguous() for a in qkv.reshape(n, t, 3, h, c3 // (3 * h)).unbind(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,d,shifted", ATTN_GEOMS)
def test_fused_window_attention_kernels_match_plain(t, h, d, shifted):
    _needs_card()
    qkv, _, bm, scale, do = _attention_inputs(t, h, d, shifted, 7)
    q, k, v = _separate(qkv, h)
    do = do.view(q.shape)
    before = (wa.fused_window_attention.launches, wa.fused_window_attention_bwd.launches)
    out = wa._forward_sep(q, k, v, bm, scale)
    _close(out, wa.attention_plain(q, k, v, bm, scale))
    grads = wa.fused_window_attention_bwd(q, k, v, bm, scale, do)
    assert (wa.fused_window_attention.launches, wa.fused_window_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = wa.attention_bwd_plain(q, k, v, bm, scale, do)
    for a, r in zip(grads[:3], ref[:3]):
        _close(a, r)
    for a, r in zip(grads[3:], ref[3:]):
        assert a.shape == r.shape and _rel(a, r) <= SUM_TOL
    again = wa.fused_window_attention_bwd(q, k, v, bm, scale, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(grads, again)), "not bit-identical"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nhtd", "nthd", "nhdt", "nhdt_packed"])
def test_fused_window_attention_op_layouts_match_plain(layout):
    """The public op on the card against the same op on the CPU (the plain
    versions), output and gradients, in each layout."""
    _needs_card()
    t, h, d, p = 16, 24, 32, 8
    qkv, _, bm, scale, do = _attention_inputs(t, h, d, False, 8)
    q, k, v = _separate(qkv, h)
    to_layout = {
        "nthd": lambda a: a,
        "nhtd": lambda a: a.permute(0, 2, 1, 3).contiguous(),
        "nhdt": lambda a: a.permute(0, 2, 3, 1).contiguous(),
        "nhdt_packed": lambda a: a.reshape(a.shape[0], t, h // p, p, d)
        .permute(0, 2, 4, 3, 1).reshape(a.shape[0], h // p, d, p * t).contiguous()}[layout]
    inputs = [to_layout(a) for a in (q, k, v)] + [bm[0], torch.zeros(1, t, t, device="cuda"),
                                                  scale]
    cot = to_layout(do.view(q.shape))
    results = []
    for dev in ("cuda", "cpu"):
        leaves = [a.to(dev).clone().requires_grad_() for a in inputs]
        out = wa.fused_window_attention(*leaves, layout=layout)
        out.backward(cot.to(dev))
        results.append([out.detach()] + [a.grad for a in leaves])
    got, ref = results
    assert got[0].shape == inputs[0].shape
    for a, r in zip(got[:4], ref[:4]):
        _close(a, r)
    for a, r in zip(got[4:], ref[4:]):
        assert _rel(a.cpu(), r) <= SUM_TOL


@pytest.mark.cuda
def test_fused_window_attention_fp32_on_card_raises():
    _needs_card()
    q = torch.randn(2, 16, 2, 32, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wa.fused_window_attention(q, q, q, torch.zeros(2, 16, 16, device="cuda"),
                                  torch.zeros(1, 16, 16, device="cuda"),
                                  torch.ones(2, device="cuda"), layout="nthd")
