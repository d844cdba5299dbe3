"""The general kernels' plain twins against the JAX package, on the CPU: the
operands and shapes the wgmma kernels do not take, which on the card go to
``csrc/window_attention_general.cu`` and ``csrc/mlp_general.cu``.

- Window attention (packed QKV) forward against the JAX op
  ``fused_window_attention_qkv`` and its backward against ``jax.vjp`` of it,
  the Pallas kernels in interpret mode, at fp32 D=32 T=64, bf16 and fp32
  D=24 T=49 (shifted), and T=400 (a 20x20 window).
- The MLP (C=48, F=144: F % 64 != 0) forward and backward against the JAX
  ``fused_mlp`` and its VJP (a Pallas branch, checked by a spy), fp32 and
  bf16.
- The dispatch rules: the wgmma kernels for bf16 at every ScOT-T/S/B/L
  shape; the general ones for fp32, D=24, T > 256 and F % 64 != 0; the fused
  tail at every MLP-kernel stage with whole 64-row tiles an image, on its
  Hopper kernels or its general ones as the MLP's.
- The wrappers' limits.
- A toy ScOT with head width 24 and mlp_ratio 3 under "pallas": forward and
  the train loss's gradients against the flax model.

Tolerances as the files they reuse: fp32 1e-5, bf16 3e-2 with the summed
cotangents by relative L2 <= 3e-2 (tests/test_torch_attention_op.py,
tests/test_torch_mlp_op.py); the model's as tests/test_torch_model.py and
tests/test_torch_train_step.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.ops import mlp as jmlp
from poseidon_tpu.ops import window_attention as jwa

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.ops import mlp as mlp_op
from poseidon_tpu_torch.ops import window_attention as wa

from test_torch_attention_grad import _packed_perm, port_grads
from test_torch_attention_op import TOL, make, port, to_qkv3
from test_torch_mlp_grad import _spy, check, jax_grads
from test_torch_mlp_grad import port_grads as mlp_port_grads
from test_torch_mlp_op import jax_op
from test_torch_mlp_op import make as make_mlp
from test_torch_mlp_op import port as mlp_port
from test_torch_model import ATOL, RTOL, build_pair, port_model, run_both
from test_torch_train_step import ABS, REL, jax_loss_fn, make_batch, to_torch

torch.set_num_threads(1)

# (T, heads, nW, D, dtype)
ATTN = [(64, 2, 1, 32, "float32"), (49, 2, 4, 24, "float32"), (49, 2, 4, 24, "bfloat16"),
        (400, 1, 1, 16, "float32")]


@pytest.mark.parametrize("t,h,nw,d,dtype", ATTN)
def test_attention_forward_and_vjp_match_jax(t, h, nw, d, dtype):
    assert wa.attention_kernel_for(getattr(torch, dtype), t, d) == "general"
    n = 2 * nw if t < 400 else 1
    qkv, qb, bias, mask, scale = make(n, h, t, d, nw, seed=7, scale_hi=10.0)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = port(qkv, qb, bias, mask, scale, h, tdt)
    ref = jwa.fused_window_attention_qkv(to_qkv3(qkv, jdt), jnp.asarray(qb), jnp.asarray(bias),
                                         jnp.asarray(mask), jnp.asarray(scale), h)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32).transpose(0, 2, 1), atol=tol, rtol=tol)

    do = np.random.default_rng(8).normal(size=(n, t, h * d)).astype(np.float32)
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
    np.testing.assert_allclose(dqkv, g_qkv, atol=tol, rtol=tol)
    for ours, ref in ((dqb, np.asarray(g_qb)[inv]), (dbias, g_bias), (dmask, g_mask),
                      (dscale, g_scale)):
        ref = np.asarray(ref, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(ours, ref, atol=tol, rtol=tol)
        else:
            assert np.linalg.norm(ours - ref) <= tol * np.linalg.norm(ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_f144_forward_and_vjp_match_jax(dtype, monkeypatch):
    c, f = 48, 144
    assert mlp_op.mlp_kernel_for(c, f, getattr(torch, dtype)) == "general"
    spies = _spy(monkeypatch, jmlp, "_call_fwd_dm"), _spy(monkeypatch, jmlp, "_call_fwd")
    x, w1, b1, w2, b2 = make_mlp(256, c, f, seed=9)
    x3 = x.reshape(2, 128, c)
    ref = jax_op(x3, w1, b1, w2, b2, dtype)
    out = mlp_port(x3, w1, b1, w2, b2, getattr(torch, dtype))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype], rtol=TOL[dtype])
    dy = np.random.default_rng(10).normal(size=x3.shape).astype(np.float32)
    ours = mlp_port_grads(x3, w1, b1, w2, b2, dy, getattr(torch, dtype))
    check(ours, jax_grads(jmlp.fused_mlp, x3, w1, b1, w2, b2, dy, dtype), dtype)
    assert sum(map(len, spies)) >= 1, "the JAX op did not take a Pallas kernel"


@pytest.mark.parametrize("size", ["T", "S", "B", "L"])
def test_dispatch_rules(size):
    cfg = pt.make_config(size, image_size=128, num_channels=4, num_out_channels=4)
    bf16, f32 = torch.bfloat16, torch.float32
    for i in range(cfg.num_stages):
        d = cfg.stage_dim(i) // cfg.num_heads[i]
        for shifted in (False, True):
            window, _ = cfg.stage_window_and_shift(i, shifted)
            assert wa.attention_kernel_for(bf16, window * window, d) == "wgmma"
            assert wa.attention_kernel_for(f32, window * window, d) == "general"
        c, l = cfg.stage_dim(i), cfg.stage_resolution(i) ** 2
        f = int(cfg.mlp_ratio * c)
        if mlp_op.use_mlp_kernel(c, l, f):
            assert mlp_op.mlp_kernel_for(c, f, bf16) == "wgmma"
            assert mlp_op.mlp_kernel_for(c, f, f32) == "general"
            assert mlp_op.use_fused_tail(c, l, f) == (l % 64 == 0)
            assert mlp_op._tail_library(mlp_op.mlp_kernel_for(c, f, bf16)) == "mlp_cln"
            assert mlp_op._tail_library(mlp_op.mlp_kernel_for(c, f, f32)) == "mlp_cln_general"
    for t in (257, 400, 576, 1024):
        assert wa.attention_kernel_for(bf16, t, 32) == "general"
    for d in (1, 8, 24, 48, 128):
        assert wa.attention_kernel_for(bf16, 256, d) == "general"
    for c, f in ((48, 144), (96, 288), (64, 256), (17, 33)):
        assert mlp_op.mlp_kernel_for(c, f, bf16) == "general"
        assert mlp_op.use_mlp_kernel(c, 1024, f) and mlp_op.use_fused_tail(c, 1024, f)
        assert mlp_op._tail_library("general") == "mlp_cln_general"
    assert not mlp_op.use_mlp_kernel(96, 1024, 8192) and not mlp_op.use_mlp_kernel(2048, 1024)


def test_wrapper_limits():
    bm = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="T <= 1024"):
        wa._check_sep(*[torch.zeros(1, 1025, 2, 8)] * 3, torch.zeros(1, 2, 1025, 1025),
                      torch.ones(2))
    with pytest.raises(ValueError, match="D <= 128"):
        wa._check_sep(*[torch.zeros(1, 16, 2, 130)] * 3, bm, torch.ones(2))
    with pytest.raises(TypeError, match="bf16 or fp32"):
        wa._check_sep(*[torch.zeros(1, 16, 2, 8, dtype=torch.float16)] * 3, bm, torch.ones(2))
    assert wa._check_sep(*[torch.zeros(1, 1024, 1, 128)] * 3, torch.zeros(1, 1, 1024, 1024),
                         torch.ones(1))[-1] == "general"
    x = torch.zeros(4, 1024)
    assert mlp_op._check(x, torch.zeros(4096, 1024), torch.zeros(4096), torch.zeros(1024, 4096),
                         torch.zeros(1024))[3] == "general"
    with pytest.raises(ValueError, match="F <= 4096"):
        mlp_op._check(torch.zeros(4, 8), torch.zeros(4097, 8), torch.zeros(4097),
                      torch.zeros(8, 4097), torch.zeros(8))
    with pytest.raises(ValueError, match="C <= 1024"):
        mlp_op._check(torch.zeros(4, 1025), torch.zeros(8, 1025), torch.zeros(8),
                      torch.zeros(1025, 8), torch.zeros(1025))
    with pytest.raises(ValueError, match="L % 64"):
        mlp_op._check_tail(torch.zeros(2, 96, 48), torch.zeros(2, 48), torch.zeros(2, 48))


# A toy ScOT with head width 24 at both stages and F = 3C, its stage 0 long
# enough (256 tokens) for the MLP kernel rule.
ODD = dict(image_size=64, embed_dim=48, depths=(2, 2), num_heads=(2, 4), mlp_ratio=3.0,
           skip_connections=(1, 0))


def test_d24_mlp_ratio3_model_forward_and_gradients_match_jax(monkeypatch):
    jcfg, jvars, pcfg, sd = build_pair(**ODD)
    assert {pcfg.stage_dim(i) // pcfg.num_heads[i] for i in range(2)} == {24}
    mlp_calls = _spy(monkeypatch, mlp_op, "mlp")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, pcfg.num_channels, 64, 64)).astype(np.float32)
    t = rng.uniform(0.1, 1.0, size=(2,)).astype(np.float32)
    y_p, y_j = run_both(jcfg, jvars, pcfg, sd, "pallas", x, t)
    np.testing.assert_allclose(y_p, y_j, atol=ATOL, rtol=RTOL)
    assert len(mlp_calls) == 2 * pcfg.depths[0]  # stage 0, encoder and decoder

    jcfg = jcfg.replace(attention_impl="pallas")
    batch = make_batch(pcfg, seed=22)
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
