"""The numerical design of the general MLP kernels with fp32 operands, on
the CPU: every product of the MLP forward and of its backward taken as the
kernels take it on the tensor cores ("3xTF32": x = hi + lo with hi =
tf32(x), lo = tf32(x - hi), and a.b = lo.hi + hi.lo + hi.hi summed in fp32),
held to the JAX package's fp32 function within the card's fp32 gate
(relative L2 <= 1e-4 per output; ``chip_smoke.py::FP32_REL_TOL``).

The port's plain versions (``mlp_plain``, ``mlp_bwd_plain``) compute every
product with the ``@`` operator and round where the kernels round; the test
runs them with ``torch.Tensor.__matmul__`` replaced by the emulation
(``tf32`` of ``tests/test_torch_tf32_split.py``), so the GELU, its
derivative, the biases and the sums stay fp32 as in the kernels. The JAX
side is the token-major ``_mlp_core`` and its ``jax.vjp``: the Pallas
kernels ``_call_fwd`` and ``_bwd_kernel_fused`` in interpret mode (a spy
shows they ran), the row tile fixed so that the kernels take the wide
shapes, whose weights exceed the TPU VMEM budget.

The one-pass TF32 error (tf32(a).tf32(b)) at the same shapes is printed,
not asserted: it is the reason the kernels pay for three products. A last
test checks the index algebra by which the kernels feed an accumulator to
the next product as its register operand: ``tf32_pos`` and its inverse,
with which the weight copies are permuted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.ops import mlp as jmlp

from poseidon_tpu_torch.ops import mlp as mlp_op

from test_torch_mlp_grad import _spy
from test_torch_tf32_split import FP32_REL_TOL, tf32

torch.set_num_threads(1)

_MATMUL = torch.Tensor.__matmul__


def matmul_3xtf32(a, b):
    """The kernels' product: lo.hi + hi.lo + hi.hi, each in fp32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return _MATMUL(al, bh) + _MATMUL(ah, bl) + _MATMUL(ah, bh)


def matmul_1xtf32(a, b):
    """One-pass TF32: tf32(a).tf32(b) in fp32."""
    return _MATMUL(tf32(a), tf32(b))


def make(m, c, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, c)).astype(np.float32)
    w1 = (rng.normal(size=(c, f)) / np.sqrt(c)).astype(np.float32)  # Dense (in, out)
    b1 = (0.1 * rng.normal(size=(f,))).astype(np.float32)
    w2 = (rng.normal(size=(f, c)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    dy = rng.normal(size=(m, c)).astype(np.float32)
    return x, w1, b1, w2, b2, dy


def jax_ref(x, w1, b1, w2, b2, dy):
    """(out, dx, dw1, db1, dw2, db2) of the JAX token-major kernels in fp32,
    the weight gradients in the port's Linear layouts."""
    out, vjp = jax.vjp(jmlp._mlp_core, *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    dx, dw1, db1, dw2, db2 = vjp(jnp.asarray(dy))
    return [np.asarray(a, np.float32) for a in (out, dx, np.asarray(dw1).T, db1,
                                                np.asarray(dw2).T, db2)]


def port(x, w1, b1, w2, b2, dy):
    """(out, dx, dw1, db1, dw2, db2) of the port's plain versions."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    w1t, w2t = t(w1.T), t(w2.T)
    out = mlp_op.mlp_plain(t(x), w1t, t(b1), w2t, t(b2))
    dx, dw1, db1, dw2, db2 = mlp_op.mlp_bwd_plain(t(x), w1t, t(b1), w2t, t(dy))
    return [a.numpy() for a in (out, dx, dw1, db1, dw2, db2)]


def rel_errors(ours, ref):
    names = ("out", "dx", "dw1", "db1", "dw2", "db2")
    return {k: float(np.linalg.norm(o - r) / np.linalg.norm(r))
            for k, o, r in zip(names, ours, ref)}


# (M, C, F): ScOT-T and ScOT-B stage 0 widths, an odd width padded on the
# card to 32 with F not a multiple of 64, ScOT-L stage 1 (C = 384, two
# blocks of output columns), and the widest the kernels take (C = 1024, F =
# 4096: the longest reductions, where one-pass TF32 errs most).
CASES = [(128, 48, 192), (128, 96, 384), (100, 17, 33), (128, 384, 1536), (64, 1024, 4096)]


@pytest.mark.parametrize("m,c,f", CASES)
def test_3xtf32_mlp_matches_jax_fp32(m, c, f, monkeypatch):
    assert mlp_op.mlp_kernel_for(c, f, torch.float32) == "general"
    data = make(m, c, f, seed=c + f)
    fwd = _spy(monkeypatch, jmlp, "_call_fwd")
    bwd = _spy(monkeypatch, jmlp, "_bwd_kernel_fused")
    monkeypatch.setattr(jmlp, "_pick_tile", lambda m_, c_, f_, itemsize: (32, True))
    ref = jax_ref(*data)
    assert fwd and bwd, "the JAX op did not take its Pallas kernels"

    errs = {}
    for name, emul in (("3xtf32", matmul_3xtf32), ("1xtf32", matmul_1xtf32)):
        monkeypatch.setattr(torch.Tensor, "__matmul__", emul)
        ours = port(*data)
        monkeypatch.setattr(torch.Tensor, "__matmul__", _MATMUL)
        errs[name] = rel_errors(ours, ref)
    print(f"M={m} C={c} F={f} relative L2 vs JAX fp32: "
          + "; ".join(f"{name} " + ", ".join(f"{k} {v:.2e}" for k, v in e.items())
                      for name, e in errs.items()))
    assert all(np.isfinite(v) for v in errs["3xtf32"].values())
    assert max(errs["3xtf32"].values()) <= FP32_REL_TOL, errs["3xtf32"]


def tf32_pos(k):
    """``csrc/wgmma.cuh::tf32_pos``: the register-operand column of key k of
    each group of 8 when an m64nN accumulator is repacked (tf32_frag)."""
    return (k & ~7) | (4 + ((k & 7) >> 1) if k & 1 else (k & 7) >> 1)


def tf32_src(p):
    """``csrc/mlp_general.cu::tf32_src``: the key at column p."""
    return (p & ~7) | (2 * (p & 7) if (p & 7) < 4 else 2 * ((p & 7) - 4) + 1)


def test_tf32_pos_repack_matches_the_permuted_weights():
    """An m64nK accumulator repacked by tf32_frag and multiplied with a
    weight slab whose reduction index is stored permuted (the prologue's
    copy, column p holding key tf32_src(p)) gives the plain product: the
    thread layouts of wgmma.cuh, written out for one warpgroup."""
    k, n = 32, 24
    assert [tf32_src(tf32_pos(i)) for i in range(k)] == list(range(k))
    rng = np.random.default_rng(0)
    acc_full = rng.normal(size=(64, k)).astype(np.float32)  # the accumulator
    w = rng.normal(size=(n, k)).astype(np.float32)          # B rows, key-major
    w_perm = w[:, [tf32_src(p) for p in range(k)]]          # the prologue's copy
    a = np.zeros((64, k), np.float32)  # the register operand, by (row, a-column)
    for warp in range(4):
        for lane in range(32):
            # Accumulator value i of the thread: row 16 warp + lane/4 + 8((i%4)/2),
            # column 8(i/4) + 2(lane%4) + i%2.
            def val(i):
                return acc_full[16 * warp + lane // 4 + 8 * ((i % 4) // 2),
                                8 * (i // 4) + 2 * (lane % 4) + i % 2]
            for kk in range(k // 8):
                frag = [val(4 * kk + 0), val(4 * kk + 2), val(4 * kk + 1), val(4 * kk + 3)]
                # Register A of a k8 step: a0 (row, col lane%4), a1 (row + 8),
                # a2 and a3 at col + 4.
                row, col = 16 * warp + lane // 4, 8 * kk + lane % 4
                a[row, col], a[row + 8, col] = frag[0], frag[1]
                a[row, col + 4], a[row + 8, col + 4] = frag[2], frag[3]
    np.testing.assert_allclose(a @ w_perm.T, acc_full @ w.T, rtol=1e-5, atol=1e-5)
