"""The port's fused MLP op (the kernel's plain version, which a CPU tensor
gets) against the JAX package's ``fused_mlp`` on both of its Pallas
branches (D-major and token-major rows, interpret mode), and the port's
dispatch rule against the JAX package's choice at ScOT-T, -S, -B and -L
geometries. fp32 atol/rtol 1e-5 (the Pallas kernels' erf is within 1.5e-7
of the exact one), bf16 3e-2."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poseidon_tpu.config import make_config as jmake_config
from poseidon_tpu.ops import mlp as jmlp

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.ops import mlp as mlp_op

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def make(m, c, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, c)).astype(np.float32)
    w1 = (0.05 * rng.normal(size=(c, f))).astype(np.float32)   # Dense (in, out)
    b1 = (0.02 * rng.normal(size=(f,))).astype(np.float32)
    w2 = (0.05 * rng.normal(size=(f, c))).astype(np.float32)
    b2 = (0.02 * rng.normal(size=(c,))).astype(np.float32)
    return x, w1, b1, w2, b2


def port(x, w1, b1, w2, b2, dtype):
    """The port's op takes PyTorch Linear layouts: w1 (F, C), w2 (C, F)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return mlp_op.mlp(t(x).to(dtype), t(w1.T).to(dtype), t(b1), t(w2.T).to(dtype), t(b2))


def jax_op(x, w1, b1, w2, b2, dtype, **kw):
    jd = getattr(jnp, dtype)
    return np.asarray(jmlp.fused_mlp(jnp.asarray(x, jd), jnp.asarray(w1, jd), jnp.asarray(b1),
                                     jnp.asarray(w2, jd), jnp.asarray(b2), **kw), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,l,c", [(2, 128, 32), (1, 256, 96), (2, 128, 48)])
def test_matches_jax_dmajor_branch(n, l, c, dtype, monkeypatch):
    called = []
    orig = jmlp._call_fwd_dm
    monkeypatch.setattr(jmlp, "_call_fwd_dm", lambda *a: called.append(1) or orig(*a))
    x, w1, b1, w2, b2 = make(n * l, c, 4 * c)
    x3 = x.reshape(n, l, c)
    ref = jax_op(x3, w1, b1, w2, b2, dtype)
    assert called, "the JAX op did not take its D-major kernel"
    out = port(x3, w1, b1, w2, b2, getattr(torch, dtype))
    assert out.shape == (n, l, c)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,c", [(100, 32), (256, 96)])
def test_matches_jax_row_branch(m, c, dtype, monkeypatch):
    # Rows not a multiple of the tile exercise the JAX op's row padding and
    # the kernel's ragged last tile.
    called = []
    orig = jmlp._call_fwd
    monkeypatch.setattr(jmlp, "_call_fwd", lambda *a: called.append(1) or orig(*a))
    x, w1, b1, w2, b2 = make(m, c, 4 * c, seed=1)
    ref = jax_op(x, w1, b1, w2, b2, dtype, min_win_tile=8)
    assert called, "the JAX op did not take its row kernel"
    out = port(x, w1, b1, w2, b2, getattr(torch, dtype))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype], rtol=TOL[dtype])


def test_two_gemm_branch_matches_jax_xla_branch():
    """A stage the rule leaves to two GEMMs matches the JAX op's XLA
    composition (the narrow-token stages 2-3)."""
    x, w1, b1, w2, b2 = make(2 * 64, 96, 384, seed=2)
    x3 = x.reshape(2, 64, 96)
    ref = jax_op(x3, w1, b1, w2, b2, "float32")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = mlp_op.fused_mlp(t(x3), t(w1.T), t(b1), t(w2.T), t(b2))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def _jax_choice(c, l, min_win_tile, batch=2):
    """Which branch the JAX package's fused_mlp takes for a (batch, l, c)
    bf16 stage: traced with jax.eval_shape, the kernel calls spied on."""
    took = []
    orig_dm, orig_row = jmlp._call_fwd_dm, jmlp._call_fwd

    def spy(tag, orig):
        def f(*a):
            took.append(tag)
            return orig(*a)
        return f

    jmlp._call_fwd_dm, jmlp._call_fwd = spy("dm", orig_dm), spy("row", orig_row)
    try:
        f = 4 * c
        sds = jax.ShapeDtypeStruct
        jax.eval_shape(lambda x, w1, b1, w2, b2: jmlp.fused_mlp(x, w1, b1, w2, b2,
                                                                min_win_tile=min_win_tile),
                       sds((batch, l, c), jnp.bfloat16), sds((c, f), jnp.bfloat16),
                       sds((f,), jnp.float32), sds((f, c), jnp.bfloat16), sds((c,), jnp.float32))
    finally:
        jmlp._call_fwd_dm, jmlp._call_fwd = orig_dm, orig_row
    return took


@pytest.mark.parametrize("size", ["T", "S", "B", "L"])
def test_dispatch_rule_matches_jax_choice(size):
    jcfg = jmake_config(size, image_size=128, num_channels=4, num_out_channels=4)
    pcfg = pt.make_config(size, image_size=128, num_channels=4, num_out_channels=4)
    picked = []
    for i in range(pcfg.num_stages):
        c, l = pcfg.stage_dim(i), pcfg.stage_resolution(i) ** 2
        jax_kernel = bool(_jax_choice(c, l, jcfg.mlp_min_win_tile))
        assert mlp_op.use_mlp_kernel(c, l) == jax_kernel, (size, i, c, l)
        picked.append(jax_kernel)
    assert picked == [True, True, False, False]


def test_cpu_tensor_takes_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(mlp_op, "mlp_plain", lambda *a: calls.append(1) or "plain")
    before = mlp_op.mlp.launches
    assert port(*make(8, 96, 384), torch.bfloat16) == "plain"
    assert calls == [1] and mlp_op.mlp.launches == before


def test_wrapper_checks():
    """fp32 operands, and bf16 widths outside the wgmma kernel's, go to the
    general kernel; past its limits the wrapper raises."""
    x, w1, b1, w2, b2 = [torch.from_numpy(np.ascontiguousarray(a)) for a in make(8, 96, 384)]
    w1, w2 = w1.t().contiguous(), w2.t().contiguous()
    assert mlp_op._check(x, w1, b1, w2, b2)[3] == "general"
    xb, w1b, w2b = x.bfloat16(), w1.bfloat16(), w2.bfloat16()
    assert mlp_op._check(xb, w1b, b1, w2b, b2)[3] == "wgmma"
    assert mlp_op._check(xb[:, :64].contiguous(), w1b[:, :64].contiguous(), b1,
                         w2b[:64].contiguous(), b2[:64].contiguous())[3] == "general"
    assert mlp_op._check(xb, w1b[:144].contiguous(), b1[:144], w2b[:, :144].contiguous(),
                         b2)[3] == "general"
    with pytest.raises(ValueError, match="C <= 1024"):
        mlp_op._check(torch.zeros(8, 1040), torch.zeros(16, 1040), torch.zeros(16),
                      torch.zeros(1040, 16), torch.zeros(1040))
    with pytest.raises(TypeError, match="bf16 or fp32"):
        mlp_op._check(x.double(), w1.double(), b1, w2.double(), b2)
    with pytest.raises(TypeError, match="fp32"):
        mlp_op._check(xb, w1b, b1.bfloat16(), w2b, b2)
    with pytest.raises(ValueError, match="contiguous"):
        mlp_op._check(xb, w1b, b1, w2b.t().contiguous().t(), b2)
    with pytest.raises(ValueError, match="unsupported device"):
        mlp_op.mlp(xb.to("meta"), w1b, b1, w2b, b2)