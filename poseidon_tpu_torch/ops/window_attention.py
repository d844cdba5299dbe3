"""Window cosine attention, forward and backward: the Hopper kernels'
wrappers, their plain PyTorch versions, and the autograd Function that
joins them.

Per (window, head) pair, with q/k/v read out of the fused QKV GEMM output::

    q  = q + qb                                  (rounded to the input dtype)
    qn = q / max(||q||, 1e-12);   kn = k / max(||k||, 1e-12)     (fp32)
    S  = cast(scale[h] * qn) @ cast(kn)^T + bm[n mod nW, h]      (fp32 accumulate)
    O  = cast(exp(S - max S)) @ v / sum(exp(S - max S))

where ``cast`` rounds to the input dtype. This is the function of
``poseidon_tpu/ops/window_attention.py::_fwd_kernel_qkv`` (with the same
rounding points as its ``_scores``/``_fwd_body``), on the port's layouts:

- ``qkv`` (N, T, 3C): the QKV GEMM output as it comes, columns
  [q | k | v], each in (head, d) order; N = images x windows, the windows
  of one image contiguous.
- ``qb`` (C,) fp32 q-projection bias (zeros when the model has none).
- ``bm`` (nW, H, T, T) fp32: CPB bias + doubled shift mask; nW = 1 for
  unshifted blocks. Window n uses ``bm[n mod nW]``.
- ``scale`` (H,) fp32: exp(min(logit_scale, log 100)).
- returns (N, T, C) in qkv's dtype, columns in (head, d) order: the
  layout the output projection GEMM consumes.

The backward (:func:`window_attention_bwd`) recomputes the scores from q
and k, as ``_bwd_kernel_qkv`` does, and returns (dqkv (N, T, 3C) in qkv's
dtype, dqb (C,), dbm (nW, H, T, T), dscale (H,)), the last three fp32 and
summed over all windows.

A CPU tensor goes to the plain version. A CUDA tensor goes to the kernel
(``csrc/window_attention.cu``, ``csrc/window_attention_bwd.cu``) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_EPS = 1e-12


def window_attention_plain(qkv: torch.Tensor, qb: torch.Tensor, bm: torch.Tensor,
                           scale: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its rounding points."""
    n, t, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    nw = bm.shape[0]
    cdt = qkv.dtype
    q, k, v = qkv.reshape(n, t, 3, heads, d).unbind(2)  # (N, T, H, D) each
    q = q + qb.reshape(heads, d).to(cdt)
    qn = q.float() / torch.clamp(torch.linalg.vector_norm(q.float(), dim=-1, keepdim=True), min=_EPS)
    kn = k.float() / torch.clamp(torch.linalg.vector_norm(k.float(), dim=-1, keepdim=True), min=_EPS)
    qs = (qn * scale.reshape(1, 1, heads, 1)).to(cdt).float()
    s = torch.einsum("nthd,nshd->nhts", qs, kn.to(cdt).float())
    s = (s.reshape(n // nw, nw, heads, t, t) + bm[None]).reshape(n, heads, t, t)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1)                                               # (N, H, T)
    o = torch.einsum("nhts,nshd->nthd", e.to(cdt).float(), v.float())
    o = o / den.transpose(1, 2)[..., None]
    return o.to(cdt).reshape(n, t, c)


def _check(qkv, qb, bm, scale, heads):
    if qkv.dtype == torch.float32:
        raise NotImplementedError(
            "window_attention kernel takes bf16 operands; fp32 kernel operands "
            "are ROADMAP queue 2 item 'fp32 operands in the kernels'")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"window_attention kernel: qkv must be bf16, got {qkv.dtype}")
    if qkv.ndim != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (N, T, 3C), got {tuple(qkv.shape)}")
    n, t, c3 = qkv.shape
    c = c3 // 3
    if c % heads:
        raise ValueError(f"C={c} is not a multiple of heads={heads}")
    d = c // heads
    if t not in (16, 64, 256) or d not in (32, 64):
        raise ValueError(f"window_attention kernel takes T in (16, 64, 256) and "
                         f"D in (32, 64), got T={t}, D={d}")
    nw = bm.shape[0]
    if bm.shape != (nw, heads, t, t) or n % nw:
        raise ValueError(f"bm must be (nW, H, T, T) with N % nW == 0, got "
                         f"{tuple(bm.shape)} for N={n}")
    if qb.shape != (c,) or scale.shape != (heads,):
        raise ValueError("qb must be (C,) and scale (H,)")
    for name, a in (("qb", qb), ("bm", bm), ("scale", scale)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32, got {a.dtype}")
    for name, a in (("qkv", qkv), ("qb", qb), ("bm", bm), ("scale", scale)):
        if a.device != qkv.device:
            raise ValueError(f"{name} is on {a.device}, qkv on {qkv.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qkv.data_ptr() % 16 or bm.data_ptr() % 32:
        raise ValueError("qkv must be 16-byte aligned and bm 32-byte aligned")
    return n, t, c, d, nw


def _forward(qkv: torch.Tensor, qb: torch.Tensor, bm: torch.Tensor,
             scale: torch.Tensor, heads: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, qb, bm, scale, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {qkv.device}")
    n, t, c, d, nw = _check(qkv, qb, bm, scale, heads)
    out = torch.empty((n, t, c), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load("window_attention", _SIGNATURES)
    err = lib.window_attention_fwd(
        qkv.data_ptr(), qb.data_ptr(), bm.data_ptr(), scale.data_ptr(),
        out.data_ptr(), n, t, heads, d, nw,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_attention kernel launch failed: {_build.error_string(lib, err)}")
    window_attention.launches += 1
    return out


def window_attention_bwd_plain(qkv: torch.Tensor, qb: torch.Tensor, bm: torch.Tensor,
                               scale: torch.Tensor, heads: int, do: torch.Tensor):
    """Plain PyTorch version of the backward kernel: the function of
    ``_bwd_body`` / ``_bwd_kernel_qkv``, with their rounding points (dod, e
    before dV, ds before dQ/dK, and dq/dk/dv rounded to the input dtype;
    everything else fp32; dqb summed from the rounded dq)."""
    n, t, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    nw = bm.shape[0]
    cdt = qkv.dtype

    def rnd(x):
        return x.to(cdt).float()

    q, k, v = qkv.reshape(n, t, 3, heads, d).unbind(2)  # (N, T, H, D) each
    qf = (q + qb.reshape(heads, d).to(cdt)).float()
    kf = k.float()
    qnorm = torch.clamp(torch.linalg.vector_norm(qf, dim=-1, keepdim=True), min=_EPS)
    knorm = torch.clamp(torch.linalg.vector_norm(kf, dim=-1, keepdim=True), min=_EPS)
    qn, kn = qf / qnorm, kf / knorm
    sc = scale.reshape(1, 1, heads, 1)
    qsb, knb = rnd(qn * sc), rnd(kn)
    s = torch.einsum("nthd,nshd->nhts", qsb, knb)
    s = (s.reshape(n // nw, nw, heads, t, t) + bm[None]).reshape(n, heads, t, t)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1, keepdim=True)                                  # (N, H, T, 1)
    dof = do.reshape(n, t, heads, d).float()
    dod = rnd(dof / den[..., 0].transpose(1, 2)[..., None])            # (N, T, H, D)
    dv = torch.einsum("nhts,nthd->nshd", rnd(e), dod).to(cdt)
    dp = torch.einsum("nthd,nshd->nhts", rnd(dof), v.float())
    ds = e * ((dp - (dp * e).sum(dim=-1, keepdim=True) / den) / den)
    dsb = rnd(ds)
    dqs = torch.einsum("nhts,nshd->nthd", dsb, knb)
    dkn = torch.einsum("nhts,nthd->nshd", dsb, qsb)
    dsrow = (dqs * qn).sum(dim=-1)                                     # (N, T, H)

    def norm_bwd(dxn, xn, nrm):
        return (dxn - xn * (dxn * xn).sum(dim=-1, keepdim=True)) / nrm

    dq = norm_bwd(dqs * sc, qn, qnorm).to(cdt)
    dk = norm_bwd(dkn, kn, knorm).to(cdt)
    dqkv = torch.stack([dq, dk, dv], dim=2).reshape(n, t, c3)
    dqb = dq.float().sum(dim=(0, 1)).reshape(c)
    dbm = ds.reshape(n // nw, nw, heads, t, t).sum(dim=0)
    return dqkv, dqb, dbm, dsrow.sum(dim=(0, 1))


def bwd_groups(n: int, nw: int, heads: int, t: int) -> int:
    """Window groups G of the backward kernel: a CTA walks the windows of
    one group that share a bias slot, and writes one fp32 partial of dbm,
    dqb and dscale per group; enough groups to fill the card, and the dbm
    partials (G x nW x H x T x T fp32) kept within 64 MiB."""
    units = nw * heads * max(1, t // 64)
    g = min(n // nw, max(1, -(-_BWD_TARGET_CTAS // units)))
    return max(1, min(g, (64 << 20) // (nw * heads * t * t * 4)))


def window_attention_bwd(qkv: torch.Tensor, qb: torch.Tensor, bm: torch.Tensor,
                         scale: torch.Tensor, heads: int, do: torch.Tensor):
    """The backward of :func:`window_attention` for the output cotangent
    ``do`` (N, T, C): (dqkv, dqb, dbm, dscale); see the module docstring."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_plain(qkv, qb, bm, scale, heads, do)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_bwd: unsupported device {qkv.device}")
    n, t, c, d, nw = _check(qkv, qb, bm, scale, heads)
    if do.shape != (n, t, c) or do.dtype != qkv.dtype or do.device != qkv.device:
        raise ValueError(f"do must be ({n}, {t}, {c}) {qkv.dtype} on {qkv.device}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError("do must be contiguous and 16-byte aligned")
    g = bwd_groups(n, nw, heads, t)
    f32 = dict(dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    dqb = torch.empty(c, **f32)
    dbm = torch.empty((nw, heads, t, t), **f32)
    dscale = torch.empty(heads, **f32)
    stats = torch.empty((n * heads * t, 3), **f32)       # row max, sum, rowsum(dp * p)
    strips = max(1, t // 64)
    part_bm = torch.empty((g, nw, heads, t, t), **f32)
    part_q = torch.empty((g * strips, nw, heads, d + 1), **f32)  # dqb | dscale
    lib = _build.load("window_attention_bwd", _BWD_SIGNATURES)
    err = lib.window_attention_bwd(
        qkv.data_ptr(), qb.data_ptr(), bm.data_ptr(), scale.data_ptr(), do.data_ptr(),
        dqkv.data_ptr(), dqb.data_ptr(), dbm.data_ptr(), dscale.data_ptr(),
        stats.data_ptr(), part_bm.data_ptr(), part_q.data_ptr(),
        n, t, heads, d, nw, g, torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_attention_bwd kernel launch failed: "
                           f"{_build.error_string(lib, err)}")
    window_attention_bwd.launches += 1
    return dqkv, dqb, dbm, dscale


class WindowAttentionFn(torch.autograd.Function):
    """Forward through the forward kernel (or its plain version on the CPU),
    backward through the backward kernel (or its plain version): the
    ``jax.custom_vjp`` of ``_attention_core_qkv``."""

    @staticmethod
    def forward(ctx, qkv, qb, bm, scale, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv, qb, bm, scale)
        return _forward(qkv, qb, bm, scale, heads)

    @staticmethod
    def backward(ctx, do):
        qkv, qb, bm, scale = ctx.saved_tensors
        dqkv, dqb, dbm, dscale = window_attention_bwd(qkv, qb, bm, scale, ctx.heads,
                                                      do.contiguous())
        return dqkv, dqb, dbm, dscale, None


def window_attention(qkv: torch.Tensor, qb: torch.Tensor, bm: torch.Tensor,
                     scale: torch.Tensor, heads: int) -> torch.Tensor:
    """Fused window cosine attention with its backward; see the module
    docstring. ``window_attention.launches`` counts forward kernel launches,
    ``window_attention_bwd.launches`` backward ones."""
    return WindowAttentionFn.apply(qkv, qb, bm, scale, heads)


window_attention.launches = 0
window_attention_bwd.launches = 0
_BWD_TARGET_CTAS = 4 * 132
_P, _I = ctypes.c_void_p, ctypes.c_int
# qkv, qb, bm, scale, out, n_windows, T, heads, D, nW, stream
_SIGNATURES = {"window_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)}
# qkv, qb, bm, scale, do, dqkv, dqb, dbm, dscale, stats, part_bm, part_q,
# n_windows, T, heads, D, nW, groups, stream
_BWD_SIGNATURES = {"window_attention_bwd": (_P,) * 12 + (_I,) * 6 + (_P,)}
