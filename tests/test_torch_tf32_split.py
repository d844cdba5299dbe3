"""The numerical design of the general attention kernels with fp32
operands, on the CPU: every product of the forward and of the VJP taken as
the kernels take it on the tensor cores ("3xTF32": x = hi + lo with hi =
tf32(x), lo = tf32(x - hi), and a.b = hi.hi + hi.lo + lo.hi summed in fp32),
held to the JAX package's fp32 function within the card's fp32 gate
(relative L2 <= 1e-4 per output; ``chip_smoke.py::FP32_REL_TOL``).

tf32 rounding is emulated on the float32 bit pattern: round to 10 mantissa
bits, to nearest with ties away from zero (``cvt.rna.tf32.f32``). The port's
plain versions (``attention_plain``, ``attention_bwd_plain``) compute every
product with ``torch.einsum``; the test runs them with ``torch.einsum``
replaced by the emulation, so the norms, the softmax and the sums stay fp32
as in the kernels. The JAX side is ``fused_window_attention_qkv`` and its
``jax.vjp``, the Pallas kernels in interpret mode (as
``tests/test_torch_general_kernels.py`` runs them).

The one-pass TF32 error (tf32(a).tf32(b)) at the same shapes is printed,
not asserted: it is the reason the kernels pay for three products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.ops import window_attention as jwa

from poseidon_tpu_torch.ops import window_attention as wa

from test_torch_attention_grad import _packed_perm, port_grads
from test_torch_attention_op import make, to_qkv3

torch.set_num_threads(1)

FP32_REL_TOL = 1e-4
_EINSUM = torch.einsum


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 mantissa bits), to nearest, ties away from
    zero, on the bit pattern of the fp32 value."""
    bits = x.float().contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, ~0x1FFF).view(torch.float32)


def einsum_3xtf32(eq, a, b):
    """The kernels' product: hi.hi + hi.lo + lo.hi, each in fp32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return _EINSUM(eq, al, bh) + _EINSUM(eq, ah, bl) + _EINSUM(eq, ah, bh)


def einsum_1xtf32(eq, a, b):
    """One-pass TF32: tf32(a).tf32(b) in fp32."""
    return _EINSUM(eq, tf32(a), tf32(b))


def jax_ref(qkv, qb, bias, mask, scale, h, do):
    """(out, dqkv, dqb, dbias, dmask, dscale) of the JAX op in fp32, in the
    port's layout."""
    n, t, c3 = qkv.shape
    c = c3 // 3
    d = c // h
    nw = mask.shape[0]
    p = jwa._pick_pack(nw, h, t)
    perm = _packed_perm(h, d, p) if p > 1 else np.arange(c)
    qkv_j = qkv.reshape(n, t, 3, c)[..., perm].reshape(n, t, 3 * c)

    def f(qkv3, qb_, bias_, mask_, scale_):
        return jwa.fused_window_attention_qkv(qkv3, qb_, bias_, mask_, scale_, h, packed_p=p)

    out, vjp = jax.vjp(f, to_qkv3(qkv_j, jnp.float32), jnp.asarray(qb[perm]), jnp.asarray(bias),
                       jnp.asarray(mask), jnp.asarray(scale))
    g_qkv3, g_qb, g_bias, g_mask, g_scale = vjp(
        jnp.asarray(do[..., perm].transpose(0, 2, 1), jnp.float32))
    inv = np.argsort(perm)
    out = np.asarray(out, np.float32).transpose(0, 2, 1)[..., inv]
    g_qkv = np.asarray(g_qkv3, np.float32).transpose(1, 3, 0, 2)[..., inv].reshape(n, t, 3 * c)
    return [out, g_qkv, np.asarray(g_qb, np.float32)[inv]] + [
        np.asarray(g, np.float32) for g in (g_bias, g_mask, g_scale)]


def rel_errors(ours, ref):
    names = ("out", "dqkv", "dqb", "dbias", "dmask", "dscale")
    return {k: float(np.linalg.norm(np.asarray(o, np.float32) - r) / np.linalg.norm(r))
            for k, o, r in zip(names, ours, ref)}


# (T, D, nW): windows of 4x4, 7x7 and 16x16; head widths padded on the card
# to 16 (D = 8) and 32 (D = 24, 32); nW = 4 a shifted block's mask.
CASES = [(t, d, nw) for t in (16, 49, 256) for d in (8, 24, 32) for nw in (1, 4)]


@pytest.mark.parametrize("t,d,nw", CASES)
def test_3xtf32_attention_matches_jax_fp32(t, d, nw, monkeypatch):
    h, n = 2, 2 * nw
    assert wa.attention_kernel_for(torch.float32, t, d) == "general"
    qkv, qb, bias, mask, scale = make(n, h, t, d, nw, seed=17, scale_hi=50.0)
    do = np.random.default_rng(18).normal(size=(n, t, h * d)).astype(np.float32)
    ref = jax_ref(qkv, qb, bias, mask, scale, h, do)

    errs = {}
    for name, emul in (("3xtf32", einsum_3xtf32), ("1xtf32", einsum_1xtf32)):
        monkeypatch.setattr(torch, "einsum", emul)
        ours = port_grads(qkv, qb, bias, mask, scale, h, do, torch.float32)
        monkeypatch.setattr(torch, "einsum", _EINSUM)
        errs[name] = rel_errors(ours, ref)
    print(f"T={t} D={d} nW={nw} relative L2 vs JAX fp32: "
          + "; ".join(f"{name} " + ", ".join(f"{k} {v:.2e}" for k, v in e.items())
                      for name, e in errs.items()))
    assert all(np.isfinite(v) for v in errs["3xtf32"].values())
    assert max(errs["3xtf32"].values()) <= FP32_REL_TOL, errs["3xtf32"]


def test_tf32_rounding():
    """The emulated rounding keeps 10 mantissa bits, rounds to nearest with
    ties away from zero, and the split's residue is exact."""
    one = 1.0 + 2.0 ** -10  # representable in tf32
    x = torch.tensor([1.0, one, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      3.0e-5, -7.25], dtype=torch.float32)
    r = tf32(x)
    assert r.tolist()[:5] == [1.0, one, one, -one, 1.0]
    bits = r.view(torch.int32)
    assert bool((torch.bitwise_and(bits, 0x1FFF) == 0).all())
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32(y)
    lo = tf32(y - hi)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21
