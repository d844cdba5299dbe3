"""The window-attention shapes that ScOT-T and ScOT-S and non-power-of-two
windows give: head width D = 16 (embed_dim 48 at every stage) and T = 49
(a 7x7 window, the config's default), unshifted and shifted (nW = 4). On the
CPU the port's op runs its kernels' plain versions; they are held to the JAX
package's Pallas kernels in interpret mode on the same numpy inputs:

- ``window_attention`` (packed QKV) forward against
  ``fused_window_attention_qkv`` and its backward against ``jax.vjp`` of it;
- the separate-q/k/v op ``fused_window_attention`` against the JAX op of
  the same name, output and gradients;
- a toy ScOT with D = 16 under ``attention_impl="pallas"``: forward and the
  train loss's gradients against the flax model.

Tolerances as tests/test_torch_attention_op.py and
tests/test_torch_attention_grad.py (fp32 1e-5, bf16 3e-2, the bf16 summed
cotangents by relative L2 <= 3e-2), and the model's as
tests/test_torch_model.py and tests/test_torch_train_step.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu import ScOT as JScOT
from poseidon_tpu.ops import window_attention as jwa

import poseidon_tpu_torch as pt
import poseidon_tpu_torch.ops as pt_ops

from test_torch_attention_grad import _packed_perm, port_grads
from test_torch_attention_op import TOL, make, port, to_qkv3
from test_torch_fused_window_attention import make as make_sep
from test_torch_model import ATOL, RTOL, build_pair, port_model, run_both
from test_torch_train_step import ABS, REL, jax_loss_fn, make_batch, to_torch

torch.set_num_threads(1)

# (T, heads, nW, D)
GEOMS = [(64, 3, 1, 16), (16, 2, 4, 16), (49, 2, 1, 32), (49, 2, 4, 32), (49, 3, 4, 16)]
DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,h,nw,d", GEOMS)
def test_forward_matches_jax(t, h, nw, d, dtype):
    n = 2 * nw
    qkv, qb, bias, mask, scale = make(n, h, t, d, nw, scale_hi=10.0)
    out = port(qkv, qb, bias, mask, scale, h, getattr(torch, dtype))
    ref = jwa.fused_window_attention_qkv(to_qkv3(qkv, getattr(jnp, dtype)), jnp.asarray(qb),
                                         jnp.asarray(bias), jnp.asarray(mask),
                                         jnp.asarray(scale), h)
    ref = np.asarray(ref, np.float32).transpose(0, 2, 1)
    assert out.shape == (n, t, h * d)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,h,nw,d", GEOMS)
def test_grads_match_jax_vjp(t, h, nw, d, dtype):
    n = 2 * nw
    qkv, qb, bias, mask, scale = make(n, h, t, d, nw, seed=5, scale_hi=10.0)
    do = np.random.default_rng(6).normal(size=(n, t, h * d)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    _, dqkv, dqb, dbias, dmask, dscale = port_grads(qkv, qb, bias, mask, scale, h, do, tdt)

    p = jwa._pick_pack(nw, h, t)
    perm = _packed_perm(h, d, p) if p > 1 else np.arange(h * d)
    c = h * d
    qkv_j = qkv.reshape(n, t, 3, c)[..., perm].reshape(n, t, 3 * c)

    def f(qkv3, qb_, bias_, mask_, scale_):
        return jwa.fused_window_attention_qkv(qkv3, qb_, bias_, mask_, scale_, h, packed_p=p)

    _, vjp = jax.vjp(f, to_qkv3(qkv_j, jdt), jnp.asarray(qb[perm]), jnp.asarray(bias),
                     jnp.asarray(mask), jnp.asarray(scale))
    g_qkv3, g_qb, g_bias, g_mask, g_scale = vjp(jnp.asarray(do[..., perm].transpose(0, 2, 1), jdt))
    inv = np.argsort(perm)
    g_qkv = np.asarray(g_qkv3, np.float32).transpose(1, 3, 0, 2)[..., inv].reshape(n, t, 3 * c)
    tol = TOL[dtype]
    np.testing.assert_allclose(dqkv, g_qkv, atol=tol, rtol=tol)
    for ours, ref in ((dqb, np.asarray(g_qb)[inv]), (dbias, g_bias), (dmask, g_mask),
                      (dscale, g_scale)):
        ref = np.asarray(ref, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(ours, ref, atol=tol, rtol=tol)
        else:
            assert np.linalg.norm(ours - ref) <= tol * np.linalg.norm(ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,h,nw,d", [(49, 2, 4, 16), (16, 3, 1, 16)])
def test_separate_qkv_op_matches_jax(t, h, nw, d, dtype):
    q, k, v, do, bias, mask, scale = make_sep(t, h, nw, d=d)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)

    def f(q_, k_, v_, bias_, mask_, scale_):
        return jwa.fused_window_attention(q_, k_, v_, bias_, mask_, scale_, layout="nhtd",
                                          windows_per_image=nw)

    out_j, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(bias),
                         jnp.asarray(mask), jnp.asarray(scale))
    grads_j = vjp(jnp.asarray(do, jdt))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    leaves += [torch.from_numpy(a).requires_grad_() for a in (bias, mask, scale)]
    out = pt_ops.fused_window_attention(*leaves, layout="nhtd", windows_per_image=nw)
    out.backward(torch.from_numpy(do).to(tdt))
    tol = TOL[dtype]
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(out_j, np.float32),
                               atol=tol, rtol=tol)
    for i, (ours, ref) in enumerate(zip(leaves, grads_j)):
        ours, ref = ours.grad.float().numpy(), np.asarray(ref, np.float32)
        if dtype == "float32" or i < 3:
            np.testing.assert_allclose(ours, ref, atol=tol, rtol=tol, err_msg=str(i))
        else:
            assert np.linalg.norm(ours - ref) <= tol * np.linalg.norm(ref), i


# A toy ScOT whose every stage has head width 16, as ScOT-T and ScOT-S do.
D16 = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4), skip_connections=(1, 0))


def test_d16_model_forward_matches_jax():
    jcfg, jvars, pcfg, sd = build_pair(**D16)
    assert all(pcfg.stage_dim(i) // pcfg.num_heads[i] == 16 for i in range(pcfg.num_stages))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, pcfg.num_channels, 32, 32)).astype(np.float32)
    t = rng.uniform(0.1, 1.0, size=(2,)).astype(np.float32)
    y_p, y_j = run_both(jcfg, jvars, pcfg, sd, "pallas", x, t)
    np.testing.assert_allclose(y_p, y_j, atol=ATOL, rtol=RTOL)


def test_d16_model_gradients_match_jax():
    jcfg, jvars, pcfg, sd = build_pair(**D16)
    jcfg = jcfg.replace(attention_impl="pallas")
    batch = make_batch(pcfg, seed=21)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg), has_aux=True))(
        jvars["params"], jvars.get("batch_stats"), jax.tree.map(jnp.asarray, batch))
    ref = pt.from_jax_params(jax.tree.map(np.asarray, grads_j), pcfg)
    model = port_model(pcfg, sd, "pallas").train()
    b = to_torch(batch)
    pred = pt.apply_pixel_mask(model(b["pixel_values"], b["time"]), b["labels"], b["pixel_mask"])
    loss = pt.scot_loss(pred, b["labels"], pcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        err = float((p.grad - ref[name]).norm())
        assert err <= REL * float(ref[name].norm()) + ABS, (name, err, float(ref[name].norm()))
