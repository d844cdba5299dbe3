"""The port's separate-q/k/v attention op, ``poseidon_tpu_torch.ops.
fused_window_attention`` (its autograd Function, which on the CPU runs the
kernels' plain versions), against the JAX package's op of the same name
(Pallas in interpret mode, so its ``_fwd_kernel`` and ``_bwd_kernel``) in
each of the four layouts, output and ``jax.vjp`` gradients of q, k, v, the
position bias, the shift mask and the logit scales. The geometries: T = 16
and T = 64 unshifted (nW = 1), where the JAX op packs P = 8 and P = 4 heads
block-diagonally (the port computes the unpacked function), and T = 64
with a shifted mask (nW = 4, no packing); the packed layout takes unshifted
windows only. The same numpy inputs and cotangent go to both sides.

Tolerances as tests/test_torch_attention_grad.py: fp32 atol/rtol 1e-5
(logit scales drawn in [1, 10]); bf16 3e-2 on the output and dq, dk, dv, and
relative L2 <= 3e-2 on the summed bias, mask and scale cotangents."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poseidon_tpu.ops import window_attention as jwa

import poseidon_tpu_torch.ops as pt_ops
from poseidon_tpu_torch.ops import window_attention as wa

from test_torch_attention_op import TOL

torch.set_num_threads(1)

# (T, heads, nW): heads chosen so that nW = 1 takes the JAX op's packing.
GEOMS = {"t16_packed": (16, 8, 1), "t64_packed": (64, 4, 1), "t64_shifted": (64, 2, 4)}
CASES = [(layout, geo) for layout in ("nhtd", "nthd", "nhdt", "nhdt_packed")
         for geo in GEOMS if layout != "nhdt_packed" or GEOMS[geo][2] == 1]


def make(t, h, nw, d=32, seed=0):
    """(N, H, T, D) q, k, v and cotangent, (H, T, T) bias, doubled (nW, T, T)
    mask, (H,) scales; N = 2 images of nW windows."""
    rng = np.random.default_rng(seed)
    n = 2 * nw
    q, k, v, do = (rng.normal(size=(n, h, t, d)).astype(np.float32) for _ in range(4))
    bias = (2.0 * rng.normal(size=(h, t, t))).astype(np.float32)
    mask = np.zeros((nw, t, t), np.float32)
    if nw > 1:
        mask[1, : t // 2, t // 2:] = -200.0
        mask[1, t // 2:, : t // 2] = -200.0
    scale = rng.uniform(1.0, 10.0, size=(h,)).astype(np.float32)
    return q, k, v, do, bias, mask, scale


def to_layout(x, layout, p):
    """(N, H, T, D) numpy into ``layout``; P heads a row for nhdt_packed."""
    n, h, t, d = x.shape
    if layout == "nhtd":
        return x
    if layout == "nthd":
        return x.transpose(0, 2, 1, 3)
    if layout == "nhdt":
        return x.transpose(0, 1, 3, 2)
    return (x.transpose(0, 1, 3, 2).reshape(n, h // p, p, d, t).transpose(0, 1, 3, 2, 4)
            .reshape(n, h // p, d, p * t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,geo", CASES)
def test_matches_jax_op_and_vjp(layout, geo, dtype, monkeypatch):
    t, h, nw = GEOMS[geo]
    jax_fwd, jax_bwd, plain_bwd = [], [], []
    for mod, name, calls in ((jwa, "_core_fwd", jax_fwd), (jwa, "_core_bwd", jax_bwd),
                             (wa, "attention_bwd_plain", plain_bwd)):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _c=calls: _c.append(1) or _o(*a))
    q, k, v, do, bias, mask, scale = make(t, h, nw)
    p = jwa._pick_pack(nw, h, t)
    assert (p > 1) == (nw == 1), "the geometry does not take the JAX op's packing as meant"
    lay = [np.ascontiguousarray(to_layout(a, layout, p)) for a in (q, k, v, do)]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)

    def f(q_, k_, v_, bias_, mask_, scale_):
        return jwa.fused_window_attention(q_, k_, v_, bias_, mask_, scale_, layout=layout,
                                          windows_per_image=nw)

    out_j, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in lay[:3]), jnp.asarray(bias),
                         jnp.asarray(mask), jnp.asarray(scale))
    grads_j = vjp(jnp.asarray(lay[3], jdt))
    assert jax_fwd and jax_bwd, "the JAX op did not take its _core_fwd/_core_bwd kernels"

    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in lay[:3]]
    leaves += [torch.from_numpy(a).requires_grad_() for a in (bias, mask, scale)]
    out = pt_ops.fused_window_attention(*leaves, layout=layout, windows_per_image=nw)
    out.backward(torch.from_numpy(lay[3]).to(tdt))
    assert plain_bwd == [1], "the backward did not go through attention_bwd_plain"
    assert out.dtype == tdt and out.shape == leaves[0].shape

    tol = TOL[dtype]
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(out_j, np.float32),
                               atol=tol, rtol=tol)
    for i, (ours, ref) in enumerate(zip(leaves, grads_j)):
        ours, ref = ours.grad.float().numpy(), np.asarray(ref, np.float32)
        assert ours.shape == ref.shape
        if dtype == "float32" or i < 3:
            np.testing.assert_allclose(ours, ref, atol=tol, rtol=tol, err_msg=str(i))
        else:
            assert np.linalg.norm(ours - ref) <= tol * np.linalg.norm(ref), i


def test_plain_bwd_is_autograd_of_plain_fwd_in_fp32():
    """In fp32 the rounding points are identities, so the plain backward is
    the exact gradient of the plain forward."""
    q, k, v, do, bias, mask, scale = [torch.from_numpy(a) for a in make(16, 2, 4, seed=1)]
    q, k, v, do = (a.transpose(1, 2).contiguous() for a in (q, k, v, do))
    bm = (bias[None] + mask[:, None]).contiguous()
    leaves = [a.clone().requires_grad_() for a in (q, k, v, bm, scale)]
    wa.attention_plain(*leaves).backward(do)
    ours = wa.attention_bwd_plain(q, k, v, bm, scale, do)
    for a, b in zip(ours, leaves):
        torch.testing.assert_close(a, b.grad, atol=1e-5, rtol=1e-5)


def test_cpu_tensor_takes_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(wa, "attention_plain", lambda *a: calls.append(1) or a[0])
    q, k, v, _, bias, mask, scale = [torch.from_numpy(a) for a in make(16, 2, 1)]
    before = wa.fused_window_attention.launches
    wa.fused_window_attention(q, k, v, bias, mask, scale)
    assert calls == [1] and wa.fused_window_attention.launches == before


def test_wrapper_checks():
    q, k, v, _, bias, mask, scale = [torch.from_numpy(a) for a in make(16, 2, 1)]
    q4 = q.transpose(1, 2).contiguous()
    bm = (bias[None] + mask[:, None]).contiguous()
    # fp32 goes to the general kernel, bf16 with any T up to 256 and D in
    # {16, 32, 64} to the wgmma kernel, other D to the general kernel.
    assert wa._check_sep(q4, q4, q4, bm, scale)[-1] == "general"
    qb = q4.to(torch.bfloat16)
    assert wa._check_sep(qb, qb, qb, bm, scale)[-1] == "wgmma"
    assert wa._check_sep(qb[:, :8].contiguous(), qb[:, :8].contiguous(),
                         qb[:, :8].contiguous(), bm[..., :8, :8].contiguous(),
                         scale)[-1] == "wgmma"
    q16 = qb[..., :16].contiguous()
    assert wa._check_sep(q16, q16, q16, bm, scale)[-1] == "wgmma"
    q8 = qb[..., :8].contiguous()
    assert wa._check_sep(q8, q8, q8, bm, scale)[-1] == "general"
    with pytest.raises(TypeError, match="bf16 or fp32"):
        wa._check_sep(q4.double(), q4.double(), q4.double(), bm, scale)
    with pytest.raises(ValueError, match="one shape"):
        wa._check_sep(qb, qb[:1], qb, bm, scale)
    with pytest.raises(ValueError, match="contiguous"):
        wa._check_sep(qb, qb, qb, bm.transpose(-1, -2), scale)
    with pytest.raises(ValueError, match="layout"):
        wa.fused_window_attention(q, k, v, bias, mask, scale, layout="ntdh")
    with pytest.raises(ValueError, match="unshifted"):
        wa.fused_window_attention(q, k, v, bias, torch.zeros(4, 16, 16), scale,
                                  layout="nhdt_packed")
    with pytest.raises(ValueError, match="windows_per_image"):
        wa.fused_window_attention(q, k, v, bias, mask, scale, windows_per_image=3)
    with pytest.raises(ValueError, match="unsupported device"):
        wa.fused_window_attention(q.to("meta"), k.to("meta"), v.to("meta"), bias.to("meta"),
                                  mask.to("meta"), scale.to("meta"))
