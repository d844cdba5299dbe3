"""The backward of the port's fused MLP op (its autograd Function, which on
the CPU runs the backward kernel's plain version) against ``jax.vjp`` of
the JAX package's op on each of its three Pallas backward branches, in
interpret mode: the D-major ``_bwd_kernel_dm``, the row-tiled
``_bwd_kernel_fused``, and ``_bwd_kernel_emit`` (whose dW products run
outside the kernel). The emit branch is forced by patching ``_pick_tile``
and differentiating ``_mlp_core`` directly: under that patch ``fused_mlp``
itself would take its XLA branch. A spy shows each branch ran. The same
numpy inputs and cotangent go to both sides.

Tolerances: fp32 atol/rtol 1e-5 (the Pallas erf is within 1.5e-7 of the
exact one); bf16 dx allclose 3e-2, and the weight and bias gradients, sums
over every row of rounded terms, relative L2 <= 3e-2."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poseidon_tpu.ops import mlp as jmlp

from poseidon_tpu_torch.ops import mlp as mlp_op

from test_torch_mlp_op import TOL, make

torch.set_num_threads(1)


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a: calls.append(1) or orig(*a))
    return calls


def port_grads(x, w1, b1, w2, b2, dy, dtype):
    """(dx, dw1, db1, dw2, db2) in the JAX package's Dense layouts."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    leaves = [t(x).to(dtype), t(w1.T).to(dtype), t(b1), t(w2.T).to(dtype), t(b2)]
    for a in leaves:
        a.requires_grad_()
    mlp_op.mlp(*leaves).backward(t(dy).to(dtype))
    g = [a.grad.float().numpy() for a in leaves]
    return g[0], g[1].T, g[2], g[3].T, g[4]


def jax_grads(fn, x, w1, b1, w2, b2, dy, dtype):
    jd = getattr(jnp, dtype)
    _, vjp = jax.vjp(fn, jnp.asarray(x, jd), jnp.asarray(w1, jd), jnp.asarray(b1),
                     jnp.asarray(w2, jd), jnp.asarray(b2))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(dy, jd))]


def check(ours, ref, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(ours[0], ref[0], atol=tol, rtol=tol)
    for a, b in zip(ours[1:], ref[1:]):
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=tol, rtol=tol)
        else:
            assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b)


def _data(m, c, seed, shape=None):
    x, w1, b1, w2, b2 = make(m, c, 4 * c, seed=seed)
    dy = np.random.default_rng(seed + 100).normal(size=(m, c)).astype(np.float32)
    if shape is not None:
        x, dy = x.reshape(shape), dy.reshape(shape)
    return x, w1, b1, w2, b2, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,l,c", [(2, 128, 32), (1, 256, 96), (2, 128, 48)])
def test_matches_jax_dmajor_branch(n, l, c, dtype, monkeypatch):
    calls = _spy(monkeypatch, jmlp, "_call_bwd_dm")
    plain = _spy(monkeypatch, mlp_op, "mlp_bwd_plain")
    data = _data(n * l, c, seed=3, shape=(n, l, c))
    ref = jax_grads(jmlp.fused_mlp, *data, dtype)
    assert calls, "the JAX op did not take its D-major backward kernel"
    check(port_grads(*data, getattr(torch, dtype)), ref, dtype)
    assert plain == [1], "the backward did not go through mlp_bwd_plain"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,c", [(100, 32), (256, 96)])
def test_matches_jax_row_fused_branch(m, c, dtype, monkeypatch):
    # Rows not a multiple of the tile: the zero-padded rows add nothing.
    calls = _spy(monkeypatch, jmlp, "_bwd_kernel_fused")
    data = _data(m, c, seed=4)
    ref = jax_grads(lambda *a: jmlp.fused_mlp(*a, min_win_tile=8), *data, dtype)
    assert calls, "the JAX op did not take its row-fused backward kernel"
    check(port_grads(*data, getattr(torch, dtype)), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,c", [(100, 32), (192, 96)])
def test_matches_jax_emit_branch(m, c, dtype, monkeypatch):
    calls = _spy(monkeypatch, jmlp, "_bwd_kernel_emit")
    monkeypatch.setattr(jmlp, "_pick_tile", lambda m_, c_, f_, itemsize: (64, False))
    data = _data(m, c, seed=5)
    ref = jax_grads(jmlp._mlp_core, *data, dtype)
    assert calls, "the JAX op did not take its emit backward kernel"
    check(port_grads(*data, getattr(torch, dtype)), ref, dtype)


def test_two_gemm_branch_grads_match_jax_xla_branch():
    """A stage the dispatch rule leaves to two GEMMs differentiates by
    plain autograd, as the JAX op's XLA branch does."""
    data = _data(2 * 64, 96, seed=6, shape=(2, 64, 96))
    ref = jax_grads(jmlp.fused_mlp, *data, "float32")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    x, w1, b1, w2, b2, dy = data
    leaves = [t(x), t(w1.T), t(b1), t(w2.T), t(b2)]
    for a in leaves:
        a.requires_grad_()
    mlp_op.fused_mlp(*leaves).backward(t(dy))
    ours = [leaves[0].grad, leaves[1].grad.t(), leaves[2].grad, leaves[3].grad.t(), leaves[4].grad]
    check([a.numpy() for a in ours], ref, "float32")


def test_plain_bwd_is_autograd_of_plain_fwd_in_fp32():
    """In fp32 the rounding points are identities, so the plain backward is
    the exact gradient of the plain forward."""
    x, w1, b1, w2, b2, dy = [torch.from_numpy(np.ascontiguousarray(a))
                             for a in _data(50, 32, seed=7)]
    leaves = [a.clone().requires_grad_() for a in (x, w1.t(), b1, w2.t(), b2)]
    mlp_op.mlp_plain(*leaves).backward(dy)
    ours = mlp_op.mlp_bwd_plain(x, w1.t(), b1, w2.t(), dy)
    for a, b in zip(ours, leaves):
        torch.testing.assert_close(a, b.grad, atol=1e-5, rtol=1e-5)
