"""Window cosine attention forward: the Hopper kernel's wrapper and its
plain PyTorch version.

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

A CPU tensor goes to the plain version. A CUDA tensor goes to the kernel
(``csrc/window_attention.cu``) or raises.
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


def window_attention(qkv: torch.Tensor, qb: torch.Tensor, bm: torch.Tensor,
                     scale: torch.Tensor, heads: int) -> torch.Tensor:
    """Fused window cosine attention forward; see the module docstring."""
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


window_attention.launches = 0
_P, _I = ctypes.c_void_p, ctypes.c_int
# qkv, qb, bm, scale, out, n_windows, T, heads, D, nW, stream
_SIGNATURES = {"window_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)}
