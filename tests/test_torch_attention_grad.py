"""The backward of the port's window-attention op (its autograd Function,
which on the CPU runs the backward kernel's plain version) against
``jax.vjp`` of the JAX package's ``fused_window_attention_qkv`` (Pallas in
interpret mode, so its ``_bwd_kernel_qkv``) for every geometry of
tests/test_torch_attention_op.py, the packed-head one included, and against
``_core_bwd_qkv`` on its own operand layout. The same numpy inputs and
output cotangent go to both sides. Checked: dqkv, the q-bias, the position
bias and shift mask cotangents, and the logit-scale cotangent. Tolerances
as the forward's: fp32 atol/rtol 1e-5, bf16 3e-2. The logit scales are
drawn in [1, 10] for both dtypes (the model's init scale is 10): the
gradients grow with the scale, and at 50 the two sides' fp32 sum orders
alone differ by 1.4e-5 in a few elements. In bf16 the four summed
cotangents (q-bias, bias, mask, scale) are held by relative L2 <= 3e-2:
they add up thousands of rounded terms whose one-ulp flips do not cancel
in a sum near zero, so an elementwise bound would test the sum's
cancellation, not the kernel."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poseidon_tpu.ops import window_attention as jwa

from poseidon_tpu_torch.ops import window_attention as wa

from test_torch_attention_op import GEOMS, TOL, make, to_qkv3

torch.set_num_threads(1)


def _packed_perm(h, d, p):
    """Port column index (head, d) for each packed column (head_group, d,
    head_in_group): the order the JAX module's QKV GEMM emits at p > 1."""
    hp = h // p
    return np.arange(h * d).reshape(hp, p, d).transpose(0, 2, 1).reshape(-1)


def port_grads(qkv, qb, bias, mask, scale, h, do, dtype):
    """(out, dqkv, dqb, dbias, dmask, dscale) through the port's Function."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qb, bias, mask, scale)]
    tq = torch.from_numpy(qkv).to(dtype).requires_grad_()
    tqb, tbias, tmask, tscale = leaves
    bm = tbias[None] + tmask[:, None]
    out = wa.window_attention(tq, tqb, bm, tscale, h)
    out.backward(torch.from_numpy(do).to(dtype))
    return [out.detach()] + [a.grad.float().numpy() for a in [tq] + leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,h,nw", GEOMS)
def test_grads_match_jax_vjp(t, h, nw, dtype, monkeypatch):
    calls = []
    orig = wa.window_attention_bwd_plain
    monkeypatch.setattr(wa, "window_attention_bwd_plain",
                        lambda *a: calls.append(1) or orig(*a))
    d, n = 32, 2 * nw
    qkv, qb, bias, mask, scale = make(n, h, t, d, nw, seed=5, scale_hi=10.0)
    do = np.random.default_rng(6).normal(size=(n, t, h * d)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    _, dqkv, dqb, dbias, dmask, dscale = port_grads(qkv, qb, bias, mask, scale, h, do, tdt)
    assert calls == [1], "the backward did not go through window_attention_bwd_plain"

    p = jwa._pick_pack(nw, h, t)
    perm = _packed_perm(h, d, p) if p > 1 else np.arange(h * d)
    c = h * d
    qkv_j = qkv.reshape(n, t, 3, c)[..., perm].reshape(n, t, 3 * c)

    def f(qkv3, qb_, bias_, mask_, scale_):
        return jwa.fused_window_attention_qkv(qkv3, qb_, bias_, mask_, scale_, h, packed_p=p)

    out_j, vjp = jax.vjp(f, to_qkv3(qkv_j, jdt), jnp.asarray(qb[perm]), jnp.asarray(bias),
                         jnp.asarray(mask), jnp.asarray(scale))
    do_j = jnp.asarray(do[..., perm].transpose(0, 2, 1), jdt)   # (N, C, T) packed order
    g_qkv3, g_qb, g_bias, g_mask, g_scale = vjp(do_j)
    inv = np.argsort(perm)
    g_qkv = np.asarray(g_qkv3, np.float32).transpose(1, 3, 0, 2)   # (N, T, 3, C)
    g_qkv = g_qkv[..., inv].reshape(n, t, 3 * c)
    tol = TOL[dtype]
    np.testing.assert_allclose(dqkv, g_qkv, atol=tol, rtol=tol)
    for ours, ref in ((dqb, np.asarray(g_qb)[inv]), (dbias, g_bias), (dmask, g_mask),
                      (dscale, g_scale)):
        ref = np.asarray(ref, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(ours, ref, atol=tol, rtol=tol)
        else:
            assert np.linalg.norm(ours - ref) <= tol * np.linalg.norm(ref)


@pytest.mark.parametrize("d", [32, 64])
def test_bwd_matches_core_bwd_qkv(d):
    """The Pallas backward kernel itself, on its own operand layout."""
    t, h, nw, n = 64, 2, 4, 4
    qkv, qb, bias, mask, scale = make(n, h, t, d, nw, seed=7, scale_hi=10.0)
    do = np.random.default_rng(8).normal(size=(n, t, h * d)).astype(np.float32)
    base = nw * h
    bm = bias[None] + mask[:, None]
    srow = np.broadcast_to(scale[None, :, None], (nw, h, t)).reshape(base, 1, t)
    qbt = np.broadcast_to(qb.reshape(1, h, d, 1), (nw, h, d, 1)).reshape(base, d, 1)
    dqkv3, dqb_j, dbm_j, dsrow_j = jwa._core_bwd_qkv(
        to_qkv3(qkv, jnp.float32).reshape(3, n * h, d, t), jnp.asarray(qbt),
        jnp.asarray(bm.reshape(base, t, t)), jnp.asarray(srow),
        jnp.asarray(do.reshape(n, t, h * d).transpose(0, 2, 1).reshape(n * h, d, t)))
    dqkv, dqb, dbm, dscale = wa.window_attention_bwd(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in (qkv, qb, bm, scale)], h,
        torch.from_numpy(do))
    ref_qkv = np.asarray(dqkv3).reshape(3, n, h * d, t).transpose(1, 3, 0, 2).reshape(n, t, -1)
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dqkv.numpy(), ref_qkv, **tol)
    np.testing.assert_allclose(dqb.numpy(), np.asarray(dqb_j).reshape(nw, h * d).sum(0), **tol)
    np.testing.assert_allclose(dbm.numpy(), np.asarray(dbm_j).reshape(nw, h, t, t), **tol)
    np.testing.assert_allclose(dscale.numpy(), np.asarray(dsrow_j).reshape(nw, h, t).sum((0, 2)),
                               **tol)


def test_plain_bwd_is_autograd_of_plain_fwd_in_fp32():
    """In fp32 the rounding points are identities, so the plain backward is
    the exact gradient of the plain forward."""
    t, h, nw, n, d = 16, 2, 4, 8, 32
    qkv, qb, bias, mask, scale = [torch.from_numpy(a) for a in make(n, h, t, d, nw, seed=9,
                                                                        scale_hi=10.0)]
    bm = (bias[None] + mask[:, None]).contiguous()
    do = torch.randn(n, t, h * d, generator=torch.Generator().manual_seed(0))
    leaves = [a.clone().requires_grad_() for a in (qkv, qb, bm, scale)]
    wa.window_attention_plain(*leaves, h).backward(do)
    ours = wa.window_attention_bwd_plain(qkv, qb, bm, scale, h, do)
    for a, b in zip(ours, leaves):
        torch.testing.assert_close(a, b.grad, atol=1e-5, rtol=1e-5)
