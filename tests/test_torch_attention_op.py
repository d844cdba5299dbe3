"""The port's window-attention op (the kernel's plain version, which a CPU
tensor gets) against the JAX package's Pallas kernel in interpret mode
(``_core_fwd_qkv`` and ``fused_window_attention_qkv``), and the port's
``WindowAttention`` module against the flax module, both impls. The same
numpy inputs go to both sides. Tolerances as tests/test_pallas_ops.py:
fp32 atol/rtol 1e-5, bf16 3e-2.

The bf16 cases draw logit scales in [1, 10] (the model's init scale is 10)
rather than [1, 50]: near 50 the bf16 scaled query has an ulp of 0.25, and
the two implementations' fp32 norms, summed in different orders, round it
differently in a few elements, which moves a logit by up to 0.25 and an
output by more than 3e-2. Both are then equally far from the fp32 result."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poseidon_tpu.models.attention import WindowAttention as JWindowAttention
from poseidon_tpu.models.attention import shifted_window_mask
from poseidon_tpu.ops import window_attention as jwa

from poseidon_tpu_torch.hub import _linear_w
from poseidon_tpu_torch.models.attention import WindowAttention
from poseidon_tpu_torch.ops import window_attention as wa

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SCALE_HI = {"float32": 50.0, "bfloat16": 10.0}


def make(n, h, t, d, nw, seed=0, scale_hi=50.0):
    """Port-layout inputs: qkv (N, T, 3C), qb (C,), bm (nW, H, T, T) =
    bias + doubled mask, scale (H,)."""
    rng = np.random.default_rng(seed)
    c = h * d
    qkv = rng.normal(size=(n, t, 3 * c)).astype(np.float32)
    qb = (0.5 * rng.normal(size=(c,))).astype(np.float32)
    bias = (2.0 * rng.normal(size=(h, t, t))).astype(np.float32)
    mask = np.zeros((nw, t, t), np.float32)
    if nw > 1:
        mask[1, : t // 2, t // 2:] = -200.0
        mask[1, t // 2:, : t // 2] = -200.0
    scale = rng.uniform(1.0, scale_hi, size=(h,)).astype(np.float32)
    return qkv, qb, bias, mask, scale


def port(qkv, qb, bias, mask, scale, h, dtype):
    bm = bias[None] + mask[:, None]
    return wa.window_attention(torch.from_numpy(qkv).to(dtype), torch.from_numpy(qb),
                               torch.from_numpy(bm), torch.from_numpy(scale), h)


def to_qkv3(qkv, dtype):
    n, t, c3 = qkv.shape
    return jnp.asarray(qkv.reshape(n, t, 3, c3 // 3).transpose(2, 0, 3, 1), dtype)


# (T, heads, nW): nW = 1 unshifted, nW = 4 a shifted block; heads 8 at
# T = 16 takes the JAX package's block-diagonal head packing.
GEOMS = [(16, 2, 1), (16, 2, 4), (64, 3, 1), (64, 3, 4), (16, 8, 1), (256, 2, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,h,nw", GEOMS)
def test_matches_fused_window_attention_qkv(t, h, nw, dtype):
    d, n = 32, 2 * nw
    qkv, qb, bias, mask, scale = make(n, h, t, d, nw, scale_hi=SCALE_HI[dtype])
    out = port(qkv, qb, bias, mask, scale, h, getattr(torch, dtype))
    ref = jwa.fused_window_attention_qkv(to_qkv3(qkv, getattr(jnp, dtype)), jnp.asarray(qb),
                                         jnp.asarray(bias), jnp.asarray(mask),
                                         jnp.asarray(scale), h)
    ref = np.asarray(ref, np.float32).transpose(0, 2, 1)  # (N, C, T) -> (N, T, C)
    assert out.dtype == getattr(torch, dtype) and out.shape == (n, t, h * d)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("d", [32, 64])
def test_matches_core_fwd_qkv(d):
    """The Pallas kernel itself, on its own operand layout."""
    t, h, nw, n = 64, 2, 4, 4
    qkv, qb, bias, mask, scale = make(n, h, t, d, nw, seed=1)
    base = nw * h
    bm = (bias[None] + mask[:, None]).reshape(base, t, t)
    srow = np.broadcast_to(scale[None, :, None], (nw, h, t)).reshape(base, 1, t)
    qbt = np.broadcast_to(qb.reshape(1, h, d, 1), (nw, h, d, 1)).reshape(base, d, 1)
    ref = jwa._core_fwd_qkv(to_qkv3(qkv, jnp.float32).reshape(3, n * h, d, t),
                            jnp.asarray(qbt), jnp.asarray(bm), jnp.asarray(srow))
    ref = np.asarray(ref).reshape(n, h * d, t).transpose(0, 2, 1)
    out = port(qkv, qb, bias, mask, scale, h, torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def _flax_attention_vars(dim, heads, window, seed):
    rng = np.random.default_rng(seed)
    m = JWindowAttention(dim=dim, num_heads=heads, window_size=window)
    x0 = jnp.zeros((1, window * window, dim))
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), x0, None)
    params = jax.tree.map(lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
                          shapes["params"])
    params["logit_scale"] = params["logit_scale"] + np.float32(math.log(10.0))
    return params


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_module_matches_flax(impl, shifted):
    dim, heads, window, side = 16, 2, 4, 8
    p = _flax_attention_vars(dim, heads, window, seed=2)
    mask = shifted_window_mask(side, side, window, 2) if shifted else None
    nw = (side // window) ** 2
    x = np.random.default_rng(3).normal(size=(2 * nw, window * window, dim)).astype(np.float32)
    jm = JWindowAttention(dim=dim, num_heads=heads, window_size=window, impl=impl,
                          windows_per_image=nw)
    y_j = np.asarray(jm.apply({"params": p}, jnp.asarray(x), mask))

    sd = {"self.logit_scale": p["logit_scale"],
          "self.continuous_position_bias_mlp.0.weight": _linear_w(p["cpb_mlp1"]["kernel"]),
          "self.continuous_position_bias_mlp.0.bias": p["cpb_mlp1"]["bias"],
          "self.continuous_position_bias_mlp.2.weight": _linear_w(p["cpb_mlp2"]["kernel"]),
          "output.dense.weight": _linear_w(p["proj"]["kernel"]),
          "output.dense.bias": p["proj"]["bias"]}
    for name in ("query", "key", "value"):
        sd[f"self.{name}.weight"] = _linear_w(p[name]["kernel"])
        if "bias" in p[name]:
            sd[f"self.{name}.bias"] = p[name]["bias"]
    pm = WindowAttention(dim, heads, window, impl=impl)
    pm.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        y_p = pm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(y_p, y_j, atol=1e-5, rtol=1e-5)


def test_cpu_tensor_takes_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(wa, "window_attention_plain", lambda *a: calls.append(1) or "plain")
    qkv, qb, bias, mask, scale = make(2, 2, 16, 32, 1)
    before = wa.window_attention.launches
    assert port(qkv, qb, bias, mask, scale, 2, torch.bfloat16) == "plain"
    assert calls == [1] and wa.window_attention.launches == before


def test_wrapper_checks():
    """bf16 with T <= 256 and D in {16, 32, 64} goes to the wgmma kernel;
    fp32, and any other T <= 1024 and D <= 128, to the general kernel; past
    those limits the wrapper raises."""
    qkv, qb, bias, mask, scale = [torch.from_numpy(a) for a in make(2, 2, 16, 32, 1)]
    bm = bias[None] + mask[:, None]
    assert wa._check(qkv, qb, bm, scale, 2)[-1] == "general"
    q16 = qkv.to(torch.bfloat16)
    assert wa._check(q16, qb, bm, scale, 2)[-1] == "wgmma"
    assert wa._check(q16[..., :96].contiguous(), qb[:32], bm, scale, 2)[-1] == "wgmma"
    qkv49, qb49, bias49, mask49, scale49 = [torch.from_numpy(a) for a in make(2, 2, 49, 32, 1)]
    assert wa._check(qkv49.to(torch.bfloat16), qb49, bias49[None] + mask49[:, None], scale49,
                     2)[-1] == "wgmma"
    big = torch.zeros(2, 257, 3 * 64, dtype=torch.bfloat16)
    assert wa._check(big, qb, torch.zeros(1, 2, 257, 257), scale, 2)[-1] == "general"
    assert wa._check(q16[..., :48].contiguous(), qb[:16], bm, scale, 2)[-1] == "general"
    with pytest.raises(ValueError, match="T <= 1024"):
        wa._check(torch.zeros(1, 1025, 3 * 64, dtype=torch.bfloat16), qb,
                  torch.zeros(1, 2, 1025, 1025), scale, 2)
    with pytest.raises(ValueError, match="D <= 128"):
        wa._check(torch.zeros(2, 16, 3 * 272, dtype=torch.bfloat16), torch.zeros(272), bm,
                  scale, 2)
    with pytest.raises(ValueError, match="bm"):
        wa._check(q16, qb, bm[:, :1], scale, 2)
    with pytest.raises(ValueError, match="contiguous"):
        wa._check(q16, qb, bm.transpose(-1, -2), scale, 2)
    with pytest.raises(TypeError, match="fp32"):
        wa._check(q16, qb.double(), bm, scale, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        wa.window_attention(q16.to("meta"), qb, bm, scale, 2)