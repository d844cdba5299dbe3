"""Fused block MLP forward: the Hopper kernel's wrapper, its plain PyTorch
version, and the rule that picks it.

    out = cast(cast(gelu(x @ w1^T + b1)) @ w2^T + b2)

with fp32 accumulation, exact (erf) GELU on the fp32 pre-activation, and
``cast`` rounding to x's dtype: the function of the TPU kernels
``poseidon_tpu/ops/mlp.py::_fwd_kernel_dm`` and ``::_fwd_kernel``, with their
rounding points. Weights are in PyTorch Linear layout: ``w1`` (F, C), ``w2``
(C, F), biases fp32.

A CPU tensor goes to the plain version. A CUDA tensor goes to the kernel
(``csrc/mlp.cu``) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.layers import dense, gelu_exact
from . import _build

KERNEL_WIDTHS = (96, 192, 384)


def mlp_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its rounding points."""
    cdt = x.dtype
    u = x.float() @ w1.to(cdt).float().t() + b1.float()
    g = gelu_exact(u).to(cdt)
    return (g.float() @ w2.to(cdt).float().t() + b2.float()).to(cdt)


def _check(x2, w1, b1, w2, b2):
    if x2.dtype == torch.float32:
        raise NotImplementedError(
            "mlp kernel takes bf16 operands; fp32 kernel operands are ROADMAP "
            "queue 2 item 'fp32 operands in the kernels'")
    m, c = x2.shape
    f = w1.shape[0]
    if x2.dtype != torch.bfloat16 or w1.dtype != torch.bfloat16 or w2.dtype != torch.bfloat16:
        raise TypeError("mlp kernel: x, w1 and w2 must be bf16")
    if b1.dtype != torch.float32 or b2.dtype != torch.float32:
        raise TypeError("mlp kernel: b1 and b2 must be fp32")
    if c not in KERNEL_WIDTHS or f % 64:
        raise ValueError(f"mlp kernel takes C in {KERNEL_WIDTHS} and F % 64 == 0, "
                         f"got C={c}, F={f}")
    if w1.shape != (f, c) or w2.shape != (c, f) or b1.shape != (f,) or b2.shape != (c,):
        raise ValueError("mlp kernel: w1 (F, C), b1 (F,), w2 (C, F), b2 (C,) expected")
    for name, a in (("x", x2), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if a.device != x2.device:
            raise ValueError(f"{name} is on {a.device}, x on {x2.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return m, c, f


def mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
        w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused MLP over the last axis of x (any leading shape)."""
    if x.device.type == "cpu":
        return mlp_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"mlp: unsupported device {x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    m, c, f = _check(x2, w1, b1, w2, b2)
    out = torch.empty((m, c), dtype=x.dtype, device=x.device)
    lib = _build.load("mlp", _SIGNATURES)
    err = lib.mlp_fwd(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                      b2.data_ptr(), out.data_ptr(), m, c, f,
                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlp kernel launch failed: {_build.error_string(lib, err)}")
    mlp.launches += 1
    return out.reshape(*lead, c)


mlp.launches = 0
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w1, b1, w2, b2, out, M, C, F, stream
_SIGNATURES = {"mlp_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P)}


def use_mlp_kernel(c: int, tokens_per_image: int) -> bool:
    """The port's dispatch rule: the fused kernel for stages with at least
    256 tokens per image and a width the kernel takes. At ScOT-B and ScOT-L
    on 128x128 inputs these are stages 0-1, where the JAX package also runs
    its Pallas kernel; the narrow-token, wide stages 2-3 run as two GEMMs."""
    return tokens_per_image >= 256 and c in KERNEL_WIDTHS


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The block MLP of a (B, L, C) token map under ``attention_impl=
    "pallas"``: the kernel where :func:`use_mlp_kernel` says so, else two
    GEMMs in x's dtype with the biases cast to it (the JAX package's XLA
    composition)."""
    if use_mlp_kernel(x.shape[-1], x.shape[1]):
        return mlp(x, w1, b1, w2, b2)
    return dense(gelu_exact(dense(x, w1, b1)), w2, b2)
