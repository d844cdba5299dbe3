"""The port's fused block tail op, ``mlp_cln`` (MLP + conditional LayerNorm
+ residual, its autograd Function ``MlpClnFn``; on the CPU the kernels'
plain versions), against the JAX package's ``fused_mlp_cln`` and its
``jax.vjp`` (Pallas in interpret mode: ``_fwd_kernel_dm_cln`` and
``_bwd_kernel_dm_cln``, spied on), at (B, L, C, F) = (3, 128, 32, 128), the
geometry of tests/test_mlp_op.py, (2, 256, 96, 384), a ScOT-B stage-0
block, (2, 128, 48, 192), a ScOT-T/S stage-0 width, and three calls that
the general tail kernels take on the card: (2, 128, 48, 144) and (2, 256,
96, 288), ScOT-T's stages 0-1 at mlp_ratio 3 (F = 3C), and (2, 128, 64,
256), a width outside ``KERNEL_WIDTHS``. The same numpy inputs, per-image
scale and shift and cotangent go to both sides; gradients of x, the MLP
weights and biases, scale and shift.

Tolerances: fp32 atol 2e-5, rtol 1e-4 (the Pallas erf is within 1.5e-7 of
the exact one, and the norm divides by a per-row deviation); bf16 the
tolerance of tests/test_torch_mlp_op.py, 3e-2, on the output and dx, and
relative L2 <= 3e-2 on the gradients summed over rows (weights, biases,
scale, shift), as tests/test_torch_mlp_grad.py holds them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poseidon_tpu.ops import mlp as jmlp

from poseidon_tpu_torch.ops import mlp as mlp_op

from test_torch_mlp_op import TOL as BF16_TOL

torch.set_num_threads(1)

EPS = 1e-5
ATOL = {"float32": 2e-5, "bfloat16": BF16_TOL["bfloat16"]}
RTOL = {"float32": 1e-4, "bfloat16": BF16_TOL["bfloat16"]}


def make(b, l, c, f, seed=0):
    """x (B, L, C), Dense-layout w1 (C, F), w2 (F, C), biases, per-image
    scale and shift (B, C) that differ by image and channel, cotangent. The
    weights are drawn with std 1/sqrt(fan-in), so that the MLP output, which
    the norm divides by its deviation, is of order 1, and the cotangent with
    std 0.1, so that the weight gradients, sums over up to 512 rows, are of
    order 1: larger, and the two sides' fp32 summation orders alone move an
    element near zero by more than the fp32 atol."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, c)).astype(np.float32)
    w1 = (rng.normal(size=(c, f)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.02 * rng.normal(size=(f,))).astype(np.float32)
    w2 = (rng.normal(size=(f, c)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.02 * rng.normal(size=(c,))).astype(np.float32)
    scale = (1.0 + 0.5 * rng.normal(size=(b, c))).astype(np.float32)
    shift = (0.5 * rng.normal(size=(b, c))).astype(np.float32)
    dy = (0.1 * rng.normal(size=(b, l, c))).astype(np.float32)
    return x, w1, b1, w2, b2, scale, shift, dy


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a: calls.append(1) or orig(*a))
    return calls


def port(x, w1, b1, w2, b2, scale, shift, dy, dtype):
    """(out, dx, dw1, db1, dw2, db2, dscale, dshift), weight gradients in
    the JAX package's Dense layouts."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    leaves = [t(x).to(dtype), t(w1.T).to(dtype), t(b1), t(w2.T).to(dtype), t(b2), t(scale),
              t(shift)]
    for a in leaves:
        a.requires_grad_()
    out = mlp_op.mlp_cln(*leaves, EPS)
    out.backward(t(dy).to(dtype))
    g = [a.grad.float().numpy() for a in leaves]
    return [out.detach().float().numpy(), g[0], g[1].T, g[2], g[3].T, g[4], g[5], g[6]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,c,f", [(3, 128, 32, 128), (2, 256, 96, 384), (2, 128, 48, 192),
                                     (2, 128, 48, 144), (2, 256, 96, 288), (2, 128, 64, 256)])
def test_matches_jax_fused_mlp_cln_and_vjp(b, l, c, f, dtype, monkeypatch):
    fwd = _spy(monkeypatch, jmlp, "_call_fwd_dm_cln")
    bwd = _spy(monkeypatch, jmlp, "_call_bwd_dm_cln")
    plain = _spy(monkeypatch, mlp_op, "mlp_cln_bwd_plain")
    x, w1, b1, w2, b2, scale, shift, dy = make(b, l, c, f)
    jd = getattr(jnp, dtype)
    out_j, vjp = jax.vjp(lambda *a: jmlp.fused_mlp_cln(*a, eps=EPS), jnp.asarray(x, jd),
                         jnp.asarray(w1, jd), jnp.asarray(b1), jnp.asarray(w2, jd),
                         jnp.asarray(b2), jnp.asarray(scale), jnp.asarray(shift))
    ref = [out_j] + list(vjp(jnp.asarray(dy, jd)))
    assert fwd and bwd, "the JAX op did not take its MLP+CLN kernels"
    ours = port(x, w1, b1, w2, b2, scale, shift, dy, getattr(torch, dtype))
    assert plain == [1], "the backward did not go through mlp_cln_bwd_plain"
    names = ("out", "dx", "dw1", "db1", "dw2", "db2", "dscale", "dshift")
    for i, (name, a, r) in enumerate(zip(names, ours, ref)):
        r = np.asarray(r, np.float32)
        assert a.shape == r.shape, name
        if dtype == "float32" or i < 2:
            np.testing.assert_allclose(a, r, atol=ATOL[dtype], rtol=RTOL[dtype], err_msg=name)
        else:
            assert np.linalg.norm(a - r) <= RTOL[dtype] * np.linalg.norm(r), name


def test_plain_bwd_is_autograd_of_plain_fwd_in_fp32():
    """In fp32 the rounding points are identities, so the plain backward is
    the exact gradient of the plain forward."""
    x, w1, b1, w2, b2, scale, shift, dy = [torch.from_numpy(np.ascontiguousarray(a))
                                           for a in make(2, 64, 32, 128, seed=1)]
    w1, w2 = w1.t().contiguous(), w2.t().contiguous()
    leaves = [a.clone().requires_grad_() for a in (x, w1, b1, w2, b2, scale, shift)]
    mlp_op.mlp_cln_plain(*leaves, EPS).backward(dy)
    ours = mlp_op.mlp_cln_bwd_plain(x, w1, b1, w2, b2, scale, EPS, dy)
    for a, b in zip(ours, leaves):
        torch.testing.assert_close(a, b.grad, atol=2e-5, rtol=1e-4)


def test_cpu_tensor_takes_plain_version(monkeypatch):
    calls = _spy(monkeypatch, mlp_op, "mlp_cln_plain")
    before = mlp_op.mlp_cln.launches
    x, w1, b1, w2, b2, scale, shift, _ = [torch.from_numpy(np.ascontiguousarray(a))
                                          for a in make(2, 64, 96, 384)]
    mlp_op.mlp_cln(x.bfloat16(), w1.t().bfloat16(), b1, w2.t().bfloat16(), b2, scale, shift)
    assert calls == [1] and mlp_op.mlp_cln.launches == before


def test_wrapper_checks():
    x, _, _, _, _, scale, shift, _ = [torch.from_numpy(a) for a in make(2, 64, 96, 384)]
    xb = x.bfloat16()
    mlp_op._check_tail(xb, scale, shift)
    with pytest.raises(ValueError, match="L % 64"):
        mlp_op._check_tail(xb[:, :32].contiguous(), scale, shift)
    with pytest.raises(ValueError, match="scale"):
        mlp_op._check_tail(xb, scale[:1].contiguous(), shift)
    with pytest.raises(ValueError, match="shift"):
        mlp_op._check_tail(xb, scale, shift.double())
    with pytest.raises(ValueError, match="contiguous"):
        mlp_op._check_tail(xb, scale, shift.t().contiguous().t())
    meta = [a.to("meta") for a in (xb, torch.zeros(384, 96), torch.zeros(384),
                                   torch.zeros(96, 384), torch.zeros(96), scale, shift)]
    with pytest.raises(ValueError, match="unsupported device"):
        mlp_op.mlp_cln(*meta)
