"""The port's CUDA kernels against their plain PyTorch versions on the card
(bf16, allclose atol = rtol = 3e-2: only rounding-order flips differ).
Outputs that are sums over many rows or windows (the weight, bias,
position-bias, q-bias and logit-scale gradients) are held by relative L2
<= 1e-2 instead: one-ulp flips of their rounded terms do not cancel in a
sum near zero. Each backward kernel also gives the same bits on two calls
(no atomics), and each autograd Function's backward agrees with autograd of
its plain forward within relative L2 5e-2 per gradient (the two round to
bf16 at different points). The general kernels (fp32 operands and the
shapes the wgmma kernels refuse) are held to the fp32 plain versions by
relative L2 <= 1e-4 (TF32 off in the plain versions; the sum order, and for
the attention kernels the 3xTF32 split, are the only differences) and in
bf16 as above; so are the general fused-tail kernels. They need a CUDA card
and skip without one. This file imports neither JAX nor the JAX package, so
it runs on a machine without them:

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


def _mlp_inputs(m, c, seed, f=None, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    f = f or 4 * c
    x = torch.randn(m, c, generator=g).to("cuda", dtype)
    w1 = (torch.randn(f, c, generator=g) / c ** 0.5).to("cuda", dtype)
    w2 = (torch.randn(c, f, generator=g) / f ** 0.5).to("cuda", dtype)
    b1 = (0.1 * torch.randn(f, generator=g)).cuda()
    b2 = (0.1 * torch.randn(c, generator=g)).cuda()
    dy = torch.randn(m, c, generator=g).to("cuda", dtype)
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
def test_fp32_on_card_takes_general_kernel():
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(9)
    x = torch.randn(64, 96, generator=g).cuda()
    w1 = (torch.randn(384, 96, generator=g) / 96 ** 0.5).cuda()
    w2 = (torch.randn(96, 384, generator=g) / 384 ** 0.5).cuda()
    b1, b2 = torch.zeros(384, device="cuda"), torch.zeros(96, device="cuda")
    before = (mlp_op.mlp.launches, mlp_op.mlp.launches_general)
    out = mlp_op.mlp(x, w1, b1, w2, b2)
    assert (mlp_op.mlp.launches, mlp_op.mlp.launches_general) == (before[0], before[1] + 1)
    assert _rel(out, mlp_op.mlp_plain(x, w1, b1, w2, b2)) <= FP32_TOL


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
def test_fused_window_attention_fp32_on_card_takes_general_kernel():
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(10)
    q, k, v = (torch.randn(2, 16, 2, 32, generator=g).cuda() for _ in range(3))
    bias = (16 * torch.sigmoid(torch.randn(2, 16, 16, generator=g))).cuda()
    mask, scale = torch.zeros(1, 16, 16, device="cuda"), torch.full((2,), 10.0, device="cuda")
    before = wa.fused_window_attention.launches_general
    out = wa.fused_window_attention(q, k, v, bias, mask, scale, layout="nthd")
    assert wa.fused_window_attention.launches_general == before + 1
    ref = wa.attention_plain(q, k, v, (bias[None] + mask[:, None]).contiguous(), scale)
    assert _rel(out, ref) <= FP32_TOL


# The general kernels (csrc/window_attention_general.cu, csrc/mlp_general.cu):
# fp32 operands against the fp32 plain versions (TF32 off) by relative L2
# <= 1e-4, the sum order being the only difference; bf16 operands at the
# wgmma kernels' tolerances. (T, H, D, shifted, dtype): ScOT-B and ScOT-T
# stage shapes in fp32, head width 24 (ScOT-T with heads (2, 4, 8, 16)),
# windows 24x24 and 32x32, and widths 1-128. The fp32 kernels run 3xTF32
# on the tensor cores (wgmma.cuh), and are held at the same 1e-4.
FP32_TOL = 1e-4
GENERAL_ATTN = [(256, 3, 32, True, "fp32"), (64, 12, 32, False, "fp32"),
                (16, 24, 32, True, "fp32"), (256, 3, 16, True, "fp32"),
                (256, 2, 24, True, "bf16"), (256, 2, 24, False, "fp32"),
                (576, 2, 32, True, "bf16"), (576, 2, 32, False, "fp32"),
                (49, 3, 40, False, "bf16"), (1024, 1, 8, False, "fp32"),
                (64, 1, 128, True, "fp32"), (16, 2, 1, False, "fp32"), (9, 2, 100, False, "bf16"),
                # Padding edges of the head width (padded in shared memory to
                # 16, 32, 64 or 128), and windows past 256 tokens that are not
                # a multiple of 64 (the forward's two-pass walk).
                (64, 2, 8, False, "fp32"), (64, 2, 8, True, "bf16"),
                (49, 2, 17, True, "fp32"), (49, 2, 17, False, "bf16"),
                (256, 2, 48, True, "fp32"), (256, 2, 48, False, "bf16"),
                (100, 2, 100, True, "fp32"), (100, 2, 100, False, "bf16"),
                (256, 1, 128, True, "fp32"), (256, 1, 128, False, "bf16"),
                (400, 2, 32, True, "fp32"), (400, 2, 24, True, "bf16"),
                (1000, 1, 32, False, "fp32"), (1000, 1, 17, False, "bf16")]


def _general_check(out, ref, dtype, sums=False):
    torch.cuda.synchronize()
    if dtype == "fp32":
        # Relative L2, plus 1e-6 absolute for a sum whose terms cancel to
        # round-off (dscale at D = 1, where qn = +-1 and the normalisation
        # passes no gradient): there both sides are fp32 noise near 1e-7.
        err = float((out.float() - ref.float()).norm())
        assert out.dtype == ref.dtype and err <= FP32_TOL * float(ref.norm()) + 1e-6, err
    elif sums:
        assert _rel(out, ref) <= SUM_TOL
    else:
        _close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,d,shifted,dtype", GENERAL_ATTN)
def test_general_attention_kernels_match_plain(t, h, d, shifted, dtype):
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv, qb, bm, scale, do = _attention_inputs(t, h, d, shifted, 11)
    if dtype == "fp32":
        qkv, do = qkv.float(), do.float()
    assert wa.attention_kernel_for(qkv.dtype, t, d) == "general"
    counts = (wa.window_attention.launches, wa.window_attention.launches_general,
              wa.window_attention_bwd.launches_general)
    out = wa.window_attention(qkv, qb, bm, scale, h)
    _general_check(out, wa.window_attention_plain(qkv, qb, bm, scale, h), dtype)
    grads = wa.window_attention_bwd(qkv, qb, bm, scale, h, do)
    assert (wa.window_attention.launches, wa.window_attention.launches_general,
            wa.window_attention_bwd.launches_general) == (counts[0], counts[1] + 1, counts[2] + 1)
    ref = wa.window_attention_bwd_plain(qkv, qb, bm, scale, h, do)
    _general_check(grads[0], ref[0], dtype)
    for a, b in zip(grads[1:], ref[1:]):
        assert a.shape == b.shape and a.dtype == torch.float32
        _general_check(a, b, dtype, sums=True)
    again = wa.window_attention_bwd(qkv, qb, bm, scale, h, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again)), "not bit-identical"


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,d,shifted,dtype", GENERAL_ATTN[:4] + GENERAL_ATTN[6:8])
def test_general_separate_qkv_kernels_match_plain(t, h, d, shifted, dtype):
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv, _, bm, scale, do = _attention_inputs(t, h, d, shifted, 12)
    if dtype == "fp32":
        qkv, do = qkv.float(), do.float()
    q, k, v = _separate(qkv, h)
    do = do.view(q.shape)
    before = (wa.fused_window_attention.launches_general,
              wa.fused_window_attention_bwd.launches_general)
    out = wa._forward_sep(q, k, v, bm, scale)
    _general_check(out, wa.attention_plain(q, k, v, bm, scale), dtype)
    grads = wa.fused_window_attention_bwd(q, k, v, bm, scale, do)
    assert (wa.fused_window_attention.launches_general,
            wa.fused_window_attention_bwd.launches_general) == (before[0] + 1, before[1] + 1)
    ref = wa.attention_bwd_plain(q, k, v, bm, scale, do)
    for a, r in zip(grads[:3], ref[:3]):
        _general_check(a, r, dtype)
    for a, r in zip(grads[3:], ref[3:]):
        _general_check(a, r, dtype, sums=True)


# (M, C, F, dtype): ScOT-B and ScOT-T stage 0-1 widths in fp32, ScOT-T's
# mlp_ratio=3 widths in bf16 (F = 144, 288), and odd and largest widths.
# fp32 operands are drawn in fp32: values rounded from bf16 have a zero lo
# part and would leave half of the 3xTF32 split untested.
GENERAL_MLP = [(4096, 96, 384, "fp32"), (4096, 48, 192, "fp32"), (2048, 48, 144, "bf16"),
               (1000, 96, 288, "bf16"), (777, 64, 200, "fp32"), (300, 1024, 4096, "fp32"),
               (100, 17, 33, "bf16"),
               # Edges of the wgmma design: rows fewer than a 64-row tile, and
               # not a multiple of one; C not a multiple of 8 or 16 (padded in
               # shared memory) in both dtypes; C = 384 and 1024 (output
               # columns in blocks of 192, x in chunks past ~450 in fp32); F
               # not a multiple of 64 in fp32 (the last step masked); ScOT-B
               # and ScOT-L fp32 stages at reduced and full rows.
               (5, 96, 384, "fp32"), (5, 48, 144, "bf16"), (333, 192, 768, "fp32"),
               (100, 17, 33, "fp32"), (200, 20, 80, "fp32"), (200, 20, 80, "bf16"),
               (300, 100, 400, "fp32"), (600, 384, 1536, "fp32"), (600, 384, 1000, "bf16"),
               (130, 1024, 4096, "bf16"), (500, 96, 100, "fp32"), (8192, 384, 1536, "fp32")]


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,f,dtype", GENERAL_MLP)
def test_general_mlp_kernels_match_plain(m, c, f, dtype):
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w1, b1, w2, b2, dy = _mlp_inputs(
        m, c, 13, f, torch.float32 if dtype == "fp32" else torch.bfloat16)
    assert mlp_op.mlp_kernel_for(c, f, x.dtype) == "general"
    before = (mlp_op.mlp.launches_general, mlp_op.mlp_bwd.launches_general)
    out = mlp_op.mlp(x, w1, b1, w2, b2)
    _general_check(out, mlp_op.mlp_plain(x, w1, b1, w2, b2), dtype)
    grads = mlp_op.mlp_bwd(x, w1, b1, w2, dy)
    assert (mlp_op.mlp.launches_general, mlp_op.mlp_bwd.launches_general) == \
        (before[0] + 1, before[1] + 1)
    ref = mlp_op.mlp_bwd_plain(x, w1, b1, w2, dy)
    _general_check(grads[0], ref[0], dtype)
    for a, b in zip(grads[1:], ref[1:]):
        assert a.shape == b.shape and a.dtype == torch.float32
        _general_check(a, b, dtype, sums=True)
    again = mlp_op.mlp_bwd(x, w1, b1, w2, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again)), "not bit-identical"


# (B, L, C, F, dtype) of the general tail kernels (csrc/mlp_cln_general.cu):
# ScOT-B's fp32 stages (C = 96: whole rows in one column block, the norm in
# the forward kernel's registers; C = 192 at 256 tokens an image: F split
# across CTAs, the norm in a row kernel), ScOT-L's C = 384 (two column
# blocks), ScOT-T's mlp_ratio-3 widths in bf16, and odd widths: C not a
# multiple of 8 or 32, F not a multiple of 64, C = 1024 with F = 4096, in
# both dtypes, with one and several images of 64 rows.
GENERAL_CLN = [(4, 1024, 96, 384, "fp32"), (8, 256, 192, 768, "fp32"),
               (4, 256, 384, 1536, "fp32"), (4, 1024, 48, 144, "bf16"),
               (4, 256, 96, 288, "bf16"), (3, 64, 17, 33, "fp32"), (3, 64, 17, 33, "bf16"),
               (2, 128, 200, 600, "bf16"), (2, 192, 64, 256, "bf16"),
               (1, 128, 1024, 4096, "fp32"), (2, 64, 1024, 4096, "bf16")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,c,f,dtype", GENERAL_CLN)
def test_general_cln_kernels_match_plain(b, l, c, f, dtype):
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    x, w1, b1, w2, b2, scale, shift, dy = _cln_inputs(b, l, c, 14, f)
    x, w1, w2, dy = (a.to(dt) for a in (x, w1, w2, dy))
    assert mlp_op._tail_library(mlp_op.mlp_kernel_for(c, f, dt)) == "mlp_cln_general"
    before = (mlp_op.mlp_cln.launches_general, mlp_op.mlp_cln_bwd.launches_general)
    out = mlp_op.mlp_cln(x, w1, b1, w2, b2, scale, shift)
    _general_check(out, mlp_op.mlp_cln_plain(x, w1, b1, w2, b2, scale, shift, 1e-5), dtype)
    args = (x, w1, b1, w2, b2, scale, 1e-5, dy)
    grads = mlp_op.mlp_cln_bwd(*args)
    assert (mlp_op.mlp_cln.launches_general, mlp_op.mlp_cln_bwd.launches_general) == \
        (before[0] + 1, before[1] + 1)
    ref = mlp_op.mlp_cln_bwd_plain(*args)
    _general_check(grads[0], ref[0], dtype)
    for a, r in zip(grads[1:], ref[1:]):
        assert a.shape == r.shape and a.dtype == torch.float32
        _general_check(a, r, dtype, sums=True)
    again = mlp_op.mlp_cln_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(grads, again)), "not bit-identical"


@pytest.mark.cuda
def test_remat_step_through_kernels_matches_plain_step():
    """A ScOT-T bf16 train-mode step (hidden dropout and drop-path on, masks
    from a CUDA generator) under ``remat=True``: the loss and the
    generator's end state equal the step without checkpointing, every
    gradient within relative L2 1e-6, and the attention and MLP forward
    kernels run twice a block (the recompute)."""
    _needs_card()
    import poseidon_tpu_torch as pt

    cfg = pt.make_config("T", image_size=128, num_channels=4, num_out_channels=4,
                         channel_slice_list=(0, 1, 3, 4), use_conditioning=True,
                         attention_impl="pallas", hidden_dropout_prob=0.1, drop_path_rate=0.1)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 4, 128, 128, generator=g).cuda()
    y = torch.randn(4, 4, 128, 128, generator=g).cuda()
    t = torch.rand(4, generator=g).cuda()
    out = {}
    for remat in (False, True):
        model = pt.build_model(cfg, device="cuda", dtype=torch.bfloat16, remat=remat).train()
        wa.window_attention.launches = mlp_op.mlp.launches = 0
        gen = torch.Generator(device="cuda").manual_seed(5)
        loss = pt.scot_loss(model(x, t, generator=gen), y, cfg)
        loss.backward()
        torch.cuda.synchronize()
        out[remat] = (loss.detach(), {k: p.grad for k, p in model.named_parameters()},
                      gen.get_state(), wa.window_attention.launches, mlp_op.mlp.launches)
    (l0, g0, s0, a0, m0), (l1, g1, s1, a1, m1) = out[False], out[True]
    assert torch.equal(l1, l0)
    assert torch.equal(s1, s0)
    for k in g0:
        assert _rel(g1[k], g0[k]) <= 1e-6 or torch.equal(g1[k], g0[k]), k
    assert a0 == 2 * sum(cfg.depths) and a1 == 2 * a0
    assert m0 > 0 and m1 == 2 * m0


@pytest.mark.cuda
def test_two_rank_ddp_step_on_one_card(tmp_path):
    """The Trainer's data-parallel step on the card: two processes on one
    card over gloo (DDP on CUDA tensors), each with four rows of a global
    batch of 8, against the one-process step on all eight (seeded ScOT-T
    shapes at 64 x 64, fp32 on the general kernels): the loss and grad
    norm within 1e-4 relative, the parameters after the AdamW step within
    relative L2 1e-5 and 1e-6 each (another summation order), both ranks
    bit-identical, and each rank's kernels launched (ScOT-T's attention and
    MLP: one forward and one backward a block)."""
    _needs_card()
    import _torch_dist as td
    import poseidon_tpu_torch as pt

    cfg = pt.make_config("T", image_size=64, num_channels=2, num_out_channels=2,
                         channel_slice_list=(0, 1, 2), use_conditioning=True,
                         attention_impl="pallas", window_size=8, depths=(2, 2),
                         num_heads=(3, 6), skip_connections=(2, 0))
    state = pt.build_model(cfg, device="cpu", seed=0).state_dict()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 2, 64, 64)).astype(np.float32)
    batch = {"pixel_values": x, "labels": (x * rng.uniform(0.5, 5, (8, 1, 1, 1))).astype(np.float32),
             "time": rng.uniform(0.1, 1, 8).astype(np.float32)}
    ranks = td.run_ranks("_torch_dist:one_step", 2, tmp_path, timeout=300, config=cfg.to_dict(),
                         state=state, batch=batch, device="cuda")
    ref = td.one_step(cfg.to_dict(), state, batch, device="cuda")
    for r in ranks:
        np.testing.assert_allclose([r["loss"], r["grad_norm"]], [ref["loss"], ref["grad_norm"]],
                                   rtol=1e-4)
        assert r["launches"]["window_attention_general_fwd"] == sum(cfg.depths) * 2
        assert r["launches"]["window_attention_general_bwd"] == sum(cfg.depths) * 2
    for k in ref["model"]:
        assert all(torch.equal(ranks[0]["model"][k], rk["model"][k]) for rk in ranks), k
    got = torch.cat([v.flatten() for v in ranks[0]["model"].values()])
    want = torch.cat([v.flatten() for v in ref["model"].values()])
    assert _rel(got, want) <= 1e-5
    # Every element within a thousandth of the learning rate (AdamW's first
    # step scales the round-off of near-zero gradients up to a share of it).
    assert float((got - want).abs().max()) <= 1e-6
