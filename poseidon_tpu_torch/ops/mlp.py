"""Fused block MLP, forward and backward: the Hopper kernels' wrappers,
their plain PyTorch versions, the autograd Function that joins them, and
the rule that picks them.

    out = cast(cast(gelu(x @ w1^T + b1)) @ w2^T + b2)

with fp32 accumulation, exact (erf) GELU on the fp32 pre-activation, and
``cast`` rounding to x's dtype: the function of the TPU kernels
``poseidon_tpu/ops/mlp.py::_fwd_kernel_dm`` and ``::_fwd_kernel``, with their
rounding points. Weights are in PyTorch Linear layout: ``w1`` (F, C), ``w2``
(C, F), biases fp32. The wgmma kernels take C in ``KERNEL_WIDTHS`` and
evaluate erf as the TPU kernels do (Abramowitz-Stegun 7.1.26, within
1.5e-7); the general kernels use ``erff`` (within 2 ulp); the plain versions
use ``torch.erf``.

The backward (:func:`mlp_bwd`) recomputes the hidden state, as the TPU
kernels ``_bwd_kernel_dm``, ``_bwd_kernel_fused`` and ``_bwd_kernel_emit``
do, and returns (dx in x's dtype, dw1, db1, dw2, db2 fp32, summed over all
rows).

The fused block tail (:func:`mlp_cln`, :func:`mlp_cln_bwd`) adds the
conditional LayerNorm and the residual of a Swin block to the MLP, the
function of ``_fwd_kernel_dm_cln`` / ``_bwd_kernel_dm_cln``; see
:func:`mlp_cln_plain`.

A CPU tensor goes to the plain version. A CUDA tensor goes to a kernel or
raises: the Hopper kernels (``csrc/mlp.cu``, ``csrc/mlp_bwd.cu``,
``csrc/mlp_cln.cu``, ``csrc/mlp_cln_bwd.cu``) for bf16 with C in
``KERNEL_WIDTHS`` and F % 64 == 0, the general kernels
(``csrc/mlp_general.cu`` for the MLP, ``csrc/mlp_cln_general.cu`` for the
fused tail, both on ``csrc/mlp_general.cuh``, the tail at C <= 384 on its
row-tile kernel ``csrc/mlp_cln_rows.cuh`` under :func:`tail_plan`: wgmma,
fp32 operands as three tf32 products of a hi/lo split, erff GELU) for fp32
operands and any other C <= 1024 and F <= 4096 (:func:`mlp_kernel_for`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..models.layers import _layer_stats, dense, gelu_exact
from . import _build

KERNEL_WIDTHS = (48, 96, 192, 384)
_INV_SQRT2PI = 0.3989422804014327


def mlp_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its rounding points."""
    cdt = x.dtype
    u = x.float() @ w1.to(cdt).float().t() + b1.float()
    g = gelu_exact(u).to(cdt)
    return (g.float() @ w2.to(cdt).float().t() + b2.float()).to(cdt)


GENERAL_MAX_C = 1024
GENERAL_MAX_F = 4096


def mlp_kernel_for(c: int, f: int, dtype: torch.dtype) -> str:
    """Which MLP kernel a call on the card runs: ``"wgmma"`` (``csrc/mlp.cu``,
    ``csrc/mlp_bwd.cu``) for bf16 operands with C in ``KERNEL_WIDTHS`` and
    F % 64 == 0, else ``"general"`` (``csrc/mlp_general.cu``: wgmma, fp32
    as 3xTF32, bf16 or fp32 operands, C <= 1024 and F <= 4096)."""
    if dtype == torch.bfloat16 and c in KERNEL_WIDTHS and f % 64 == 0:
        return "wgmma"
    return "general"


def _check(x2, w1, b1, w2, b2=None):
    """Checks the kernels' operands (b2 is not an operand of the backward).
    Returns (M, C, F, the kernel that takes the call)."""
    m, c = x2.shape
    f = w1.shape[0]
    biases = (b1,) if b2 is None else (b1, b2)
    if x2.dtype not in (torch.bfloat16, torch.float32) or w1.dtype != x2.dtype \
            or w2.dtype != x2.dtype:
        raise TypeError(f"mlp kernels: x, w1 and w2 must be bf16 or fp32 of one dtype, got "
                        f"{x2.dtype}, {w1.dtype}, {w2.dtype}")
    if any(b.dtype != torch.float32 for b in biases):
        raise TypeError("mlp kernels: b1 and b2 must be fp32")
    if not (1 <= c <= GENERAL_MAX_C and 1 <= f <= GENERAL_MAX_F):
        raise ValueError(f"mlp kernels take C <= {GENERAL_MAX_C} and F <= {GENERAL_MAX_F}, "
                         f"got C={c}, F={f}")
    if w1.shape != (f, c) or w2.shape != (c, f) or b1.shape != (f,) or \
            (b2 is not None and b2.shape != (c,)):
        raise ValueError("mlp kernels: w1 (F, C), b1 (F,), w2 (C, F), b2 (C,) expected")
    kernel = mlp_kernel_for(c, f, x2.dtype)
    for name, a in zip(("x", "w1", "w2", "b1", "b2"), (x2, w1, w2) + biases):
        if a.device != x2.device:
            raise ValueError(f"{name} is on {a.device}, x on {x2.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if kernel == "wgmma" and a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return m, c, f, kernel


def _tail_library(kernel: str) -> str:
    """The library of the fused tail's kernels for a call that ``kernel``
    (:func:`mlp_kernel_for`) takes: ``"mlp_cln"`` (the Hopper kernels) for
    ``"wgmma"``, ``"mlp_cln_general"`` for ``"general"``."""
    return "mlp_cln" if kernel == "wgmma" else "mlp_cln_general"


def _check_dy(dy2, x2, kernel="wgmma"):
    """Checks a backward kernel's output cotangent against its input rows."""
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype or dy2.device != x2.device \
            or not dy2.is_contiguous() or (kernel == "wgmma" and dy2.data_ptr() % 16):
        raise ValueError("dy must be contiguous, 16-byte aligned, and of x's shape, dtype "
                         "and device")


def _forward(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return mlp_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"mlp: unsupported device {x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    m, c, f, kernel = _check(x2, w1, b1, w2, b2)
    out = torch.empty((m, c), dtype=x.dtype, device=x.device)
    if kernel == "general":
        lib = _build.load("mlp_general", _GENERAL_SIGNATURES)
        fp32 = int(x.dtype == torch.float32)
        scratch = _general_scratch(lib, 0, m, c, f, 0, fp32, x.device)
        _build.launch(lib, "mlp_general_fwd", x.device, x2.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), scratch.data_ptr(), m, c,
            f, fp32, torch.cuda.current_stream(x.device).cuda_stream)
        mlp.launches_general += 1
        return out.reshape(*lead, c)
    lib = _build.load("mlp", _SIGNATURES)
    _build.launch(lib, "mlp_fwd", x.device, x2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), m, c, f,
        torch.cuda.current_stream(x.device).cuda_stream)
    mlp.launches += 1
    return out.reshape(*lead, c)


def mlp_bwd_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, dy: torch.Tensor):
    """Plain PyTorch version of the backward kernel, with the rounding
    points of ``_recompute`` / ``_bwd_kernel_dm``: du and g rounded to x's
    dtype before the weight products, fp32 accumulation, db1 from the
    unrounded du."""
    dx, dw1, db1, dw2, db2 = _mlp_bwd_f32(x, w1, b1, w2, dy)
    return dx.to(x.dtype).reshape(x.shape), dw1, db1, dw2, db2


def _mlp_bwd_f32(x, w1, b1, w2, dy):
    """:func:`mlp_bwd_plain` with dx as its fp32 (rows, C) sum."""
    cdt = x.dtype
    c = x.shape[-1]
    xf = x.reshape(-1, c).float()
    dyf = dy.reshape(-1, c).float()
    w1f, w2f = w1.to(cdt).float(), w2.to(cdt).float()
    u = xf @ w1f.t() + b1.float()
    dgelu = 0.5 * (1.0 + torch.erf(u * 0.7071067811865476)) + u * torch.exp(-0.5 * u * u) * _INV_SQRT2PI
    du = (dyf @ w2f) * dgelu
    dub = du.to(cdt).float()
    g = gelu_exact(u).to(cdt).float()
    return dub @ w1f, dub.t() @ xf, du.sum(dim=0), dyf.t() @ g, dyf.sum(dim=0)


def bwd_splits(m: int, c: int, f: int) -> int:
    """Row splits R of the backward kernel's weight-gradient CTAs. Each CTA
    takes one 64-wide step of F and one chunk of the columns (C, or two of
    192 at C = 384) and walks its split's row groups (128 rows; 64 at
    C = 384); each split writes one fp32 partial of (dw1, dw2, db1, db2).
    About one such CTA an SM (four at C = 384, whose CTAs are short), the
    partials kept within 64 MiB: the counts that measured fastest on the
    H100 at the ScOT-T, -B and -L shapes (PERF.md)."""
    rows, chunks = (64, 2) if c == 384 else (128, 1)
    out_floats = 2 * f * c + f + c
    target = _BWD_TARGET_CTAS * (4 if c == 384 else 1)
    r = -(-target // max(1, (f // 64) * chunks))
    return max(1, min(-(-m // rows), r, (64 << 20) // (4 * out_floats)))


def mlp_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
            dy: torch.Tensor):
    """The backward of :func:`mlp` for the output cotangent ``dy``:
    (dx, dw1, db1, dw2, db2); see the module docstring."""
    if x.device.type == "cpu":
        return mlp_bwd_plain(x, w1, b1, w2, dy)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_bwd: unsupported device {x.device}")
    x2 = x.reshape(-1, x.shape[-1])
    dy2 = dy.reshape(-1, dy.shape[-1])
    m, c, f, kernel = _check(x2, w1, b1, w2)
    _check_dy(dy2, x2, kernel)
    if kernel == "general":
        return _general_bwd(x2, w1, b1, w2, dy2, m, c, f, x.shape)
    n_out = 2 * f * c + f + c
    r = bwd_splits(m, c, f)
    dx = torch.empty_like(x2)
    grads = torch.empty(n_out, dtype=torch.float32, device=x.device)
    part = torch.empty((r, n_out), dtype=torch.float32, device=x.device)
    lib = _build.load("mlp_bwd", _BWD_SIGNATURES)
    _build.launch(lib, "mlp_bwd", x.device, x2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), dy2.data_ptr(), dx.data_ptr(), grads.data_ptr(), part.data_ptr(), m, c, f,
        r, torch.cuda.current_stream(x.device).cuda_stream)
    mlp_bwd.launches += 1
    dw1, dw2, db1, db2 = grads.split([f * c, c * f, f, c])
    return dx.reshape(x.shape), dw1.view(f, c), db1, dw2.view(c, f), db2


def general_bwd_splits(m: int, c: int, f: int) -> int:
    """Row splits R of the general backward's weight-gradient CTAs (one per
    64 hidden rows and block of at most 192 output columns, two
    warpgroups, about one CTA an SM): enough splits for one CTA an SM, at
    most one per 64 rows, and the (R, 2 F C) fp32 partials kept within
    64 MiB."""
    tiles = -(-f // 64) * -(-c // 192)
    r = -(-_BWD_TARGET_CTAS // tiles)
    return max(1, min(r, -(-m // 64), (64 << 20) // (8 * f * c)))


def _general_scratch(lib, bwd, m, c, f, r, fp32, device):
    """The general kernels' scratch for a call (their pre-split weights,
    partial sums and, for the backward, du, g, x and dy transposed)."""
    nbytes = ctypes.c_longlong(0)
    err = lib.mlp_general_scratch(bwd, m, c, f, r, fp32, ctypes.addressof(nbytes))
    return _scratch_buffer(lib, err, nbytes, device)


def _scratch_buffer(lib, err, nbytes, device):
    """The scratch buffer of a general kernel's plan query's answer."""
    if err != 0:
        raise RuntimeError(f"mlp general kernel plan failed: {_build.error_string(lib, err)}")
    return torch.empty(max(1, nbytes.value), dtype=torch.uint8, device=device)


def _general_bwd(x2, w1, b1, w2, dy2, m, c, f, x_shape):
    """The general backward kernels' launch: (dx, dw1, db1, dw2, db2)."""
    r = general_bwd_splits(m, c, f)
    fp32 = int(x2.dtype == torch.float32)
    dx = torch.empty_like(x2)
    grads = torch.empty(2 * f * c + f + c, dtype=torch.float32, device=x2.device)
    lib = _build.load("mlp_general", _GENERAL_SIGNATURES)
    scratch = _general_scratch(lib, 1, m, c, f, r, fp32, x2.device)
    _build.launch(lib, "mlp_general_bwd", x2.device, x2.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), dy2.data_ptr(), dx.data_ptr(), grads.data_ptr(),
        scratch.data_ptr(), m, c, f, r, fp32, torch.cuda.current_stream(x2.device).cuda_stream)
    mlp_bwd.launches_general += 1
    dw1, dw2, db1, db2 = grads.split([f * c, c * f, f, c])
    return dx.reshape(x_shape), dw1.view(f, c), db1, dw2.view(c, f), db2


class MlpFn(torch.autograd.Function):
    """Forward through the forward kernel (or its plain version on the CPU),
    backward through the backward kernel (or its plain version): the
    ``jax.custom_vjp`` of ``_mlp_core_dm`` / ``_mlp_core``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        return _forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        return mlp_bwd(x, w1, b1, w2, dy.contiguous())


def mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
        w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused MLP over the last axis of x (any leading shape), with its
    backward. ``mlp.launches`` counts forward launches of the wgmma kernel,
    ``mlp_bwd.launches`` backward ones; their ``launches_general`` count the
    general kernel's."""
    return MlpFn.apply(x, w1, b1, w2, b2)


mlp.launches = 0
mlp_bwd.launches = 0
mlp.launches_general = 0
mlp_bwd.launches_general = 0
_BWD_TARGET_CTAS = 132
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w1, b1, w2, b2, out, M, C, F, stream
_SIGNATURES = {"mlp_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P), "mlp_fwd_info": (_I, _P)}
# x, w1, b1, w2, dy, dx, grads, partials, M, C, F, R, stream
_BWD_SIGNATURES = {"mlp_bwd": (_P,) * 8 + (_I,) * 4 + (_P,), "mlp_bwd_info": (_I, _P)}
_GENERAL_SIGNATURES = {
    # x, w1, b1, w2, b2, out, scratch, M, C, F, fp32, stream
    "mlp_general_fwd": (_P,) * 7 + (_I,) * 4 + (_P,),
    # x, w1, b1, w2, dy, dx, grads, scratch, M, C, F, R, fp32, stream
    "mlp_general_bwd": (_P,) * 8 + (_I,) * 5 + (_P,),
    # bwd, M, C, F, R, fp32, long long out: scratch bytes
    "mlp_general_scratch": (_I,) * 6 + (_P,),
    # kernel, fp32, output width, int[3] out: registers, spill bytes, shared-memory bytes
    "mlp_general_info": (_I, _I, _I, _P),
}
# Output columns a warpgroup of the general kernels holds, by instantiation.
GENERAL_WIDTHS = (32, 48, 64, 96, 128, 192)


def kernel_info() -> dict:
    """Registers, local-memory (spill) bytes and dynamic shared-memory bytes
    of every instantiation of the four wgmma MLP kernels (the tail
    backward's prologue; its middle launch is the MLP backward's kernel), by
    width C, and of the general kernels' seven, by operand type and, for the
    forward, rows and weight kernels, by the output width a warpgroup holds
    (``GENERAL_WIDTHS``; dynamic shared memory of the plan at C = that width,
    F = 4C, M = 32768; the rows kernel whose warpgroups split a step at 192
    only), and of the general tail's own (its forward kernel by output
    width, its row kernels by C, its reduce; the row-tile kernel by the
    output columns NH a warpgroup holds, forward and backward with one row
    tile a CTA and backward with two (NH <= 96), whose shared memory is its plan's, and
    that path's prologue and reduce). Builds and loads them."""
    out = {}
    for name, sigs, entry in (("mlp", _SIGNATURES, "mlp_fwd_info"),
                              ("mlp_bwd", _BWD_SIGNATURES, "mlp_bwd_info"),
                              ("mlp_cln", _CLN_SIGNATURES, "mlp_cln_fwd_info"),
                              ("mlp_cln_bwd", _CLN_BWD_SIGNATURES, "mlp_cln_bwd_info")):
        fn = getattr(_build.load(name, sigs), entry)
        for c in KERNEL_WIDTHS:
            vals = (ctypes.c_int * 3)()
            err = fn(c, ctypes.addressof(vals))
            if err != 0:
                raise RuntimeError(f"{name} info failed: {err}")
            out[f"{name} C={c}"] = {"registers": vals[0], "spill_bytes": vals[1],
                                    "smem_bytes": vals[2]}
    fn = _build.load("mlp_cln_general", _CLN_GENERAL_SIGNATURES).mlp_cln_general_info
    for kernel, kname, widths in ((0, "fwd", GENERAL_WIDTHS), (1, "fwd_rows", CLN_ROW_WIDTHS),
                                  (2, "bwd_rows", CLN_ROW_WIDTHS), (3, "reduce", (0,)),
                                  (4, "rows fwd", GENERAL_WIDTHS), (5, "rows bwd", GENERAL_WIDTHS),
                                  (8, "rows2 bwd", GENERAL_WIDTHS[:4]),
                                  (6, "tail_prep", (0,)), (7, "tail_reduce", (0,))):
        for fp32 in (0, 1):
            for nw in widths:
                vals = (ctypes.c_int * 3)()
                err = fn(kernel, fp32, nw, ctypes.addressof(vals))
                if err != 0:
                    raise RuntimeError(f"mlp_cln_general info failed: {err}")
                key = f"mlp_cln_general {kname} {'fp32' if fp32 else 'bf16'}"
                by_nh = kernel in (4, 5, 8)
                out[key + (f" NW={nw}" if kernel == 0 else f" NH={nw}" if by_nh
                           else f" C={nw}" if nw else "")] = {
                    "registers": vals[0], "spill_bytes": vals[1], "smem_bytes": vals[2]}
    fn = _build.load("mlp_general", _GENERAL_SIGNATURES).mlp_general_info
    names = ("fwd", "bwd_rows", "bwd_dw", "prep", "sum_splits", "bwd_reduce", "bwd_rows_split")
    for kernel, kname in enumerate(names):
        for fp32 in (0, 1):
            by_width = kernel in (0, 1, 2, 6)
            for nw in (GENERAL_WIDTHS[-1:] if kernel == 6 else GENERAL_WIDTHS) if by_width else (0,):
                vals = (ctypes.c_int * 3)()
                err = fn(kernel, fp32, nw, ctypes.addressof(vals))
                if err != 0:
                    raise RuntimeError(f"mlp_general info failed: {err}")
                key = f"mlp_general {kname} {'fp32' if fp32 else 'bf16'}"
                out[key + (f" NW={nw}" if by_width else "")] = {
                    "registers": vals[0], "spill_bytes": vals[1], "smem_bytes": vals[2]}
    return out


def use_mlp_kernel(c: int, tokens_per_image: int, f: Optional[int] = None) -> bool:
    """The port's dispatch rule: a fused MLP kernel for stages with at least
    256 tokens per image, at the widths the kernels take (C <= 1024, F <=
    4096; F defaults to 4C). At ScOT-T/S, ScOT-B and ScOT-L on 128x128
    inputs these are stages 0-1, where the JAX package also runs its Pallas
    kernel; the narrow-token, wide stages 2-3 run as two GEMMs. Which kernel
    runs is :func:`mlp_kernel_for`'s choice."""
    f = 4 * c if f is None else f
    return tokens_per_image >= 256 and c <= GENERAL_MAX_C and f <= GENERAL_MAX_F


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The block MLP of a (B, L, C) token map under ``attention_impl=
    "pallas"``: the kernel where :func:`use_mlp_kernel` says so, else two
    GEMMs in x's dtype with the biases cast to it (the JAX package's XLA
    composition)."""
    if use_mlp_kernel(x.shape[-1], x.shape[1], w1.shape[0]):
        return mlp(x, w1, b1, w2, b2)
    return dense(gelu_exact(dense(x, w1, b1)), w2, b2)


# ---------------------------------------------------------------------------
# The fused block tail: MLP + conditional LayerNorm + residual
# ---------------------------------------------------------------------------

def _cln_stats(o: torch.Tensor, eps: float):
    """(yhat, r) of fp32 rows: r = rsqrt(var + eps) with the variance
    E[o^2] - mu^2 clamped at 0, as ``_cln`` computes it."""
    mu = o.mean(-1, keepdim=True)
    var = torch.clamp((o * o).mean(-1, keepdim=True) - mu * mu, min=0.0)
    r = torch.rsqrt(var + eps)
    return (o - mu) * r, r


def mlp_cln_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Plain PyTorch version of the fused tail kernel on a (B, L, C) stream
    x with per-image fp32 ``scale`` and ``shift`` (B, C), with the rounding
    points of ``_fwd_kernel_dm_cln``::

        o   = mlp(x)                                   (rounded to x's dtype)
        out = cast(x + cast(scale[b] * (o - mu) * r + shift[b]))
    """
    cdt = x.dtype
    yhat, _ = _cln_stats(mlp_plain(x, w1, b1, w2, b2).float(), eps)
    y = (scale.float()[:, None] * yhat + shift.float()[:, None]).to(cdt)
    return (x.float() + y.float()).to(cdt)


def mlp_cln_bwd_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor, scale: torch.Tensor, eps: float, dy: torch.Tensor):
    """Plain PyTorch version of the fused tail's backward kernel, with the
    rounding points of ``_bwd_kernel_dm_cln``: the norm's backward ``do`` in
    fp32, rounded to x's dtype as the MLP backward's cotangent, db2 summed
    from the fp32 ``do``, and dx = cast(dy + dx_mlp) rounded once. Returns
    (dx, dw1, db1, dw2, db2, dscale, dshift); dscale and dshift (B, C) are
    per-image sums."""
    cdt = x.dtype
    yhat, r = _cln_stats(mlp_plain(x, w1, b1, w2, b2).float(), eps)
    dyf = dy.float()
    dyh = dyf * scale.float()[:, None]
    do = r * (dyh - dyh.mean(-1, keepdim=True) - yhat * (dyh * yhat).mean(-1, keepdim=True))
    dxm, dw1, db1, dw2, _ = _mlp_bwd_f32(x, w1, b1, w2, do.to(cdt))
    dx = (dyf.reshape(dxm.shape) + dxm).to(cdt).reshape(x.shape)
    return dx, dw1, db1, dw2, do.sum(dim=(0, 1)), (dyf * yhat).sum(dim=1), dyf.sum(dim=1)


def _check_tail(x, scale, shift=None):
    """Checks the fused tail's operands beyond the MLP's: a (B, L, C) stream
    with whole 64-row tiles per image, and per-image fp32 (B, C) scale and
    shift."""
    if x.ndim != 3 or x.shape[1] % 64:
        raise ValueError(f"mlp_cln kernel takes x (B, L, C) with L % 64 == 0, "
                         f"got {tuple(x.shape)}")
    b, _, c = x.shape
    for name, a in (("scale", scale), ("shift", shift)):
        if a is None:
            continue
        if a.shape != (b, c) or a.dtype != torch.float32:
            raise ValueError(f"{name} must be ({b}, {c}) fp32, got {tuple(a.shape)} {a.dtype}")
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")


def _forward_cln(x, w1, b1, w2, b2, scale, shift, eps):
    if x.device.type == "cpu":
        return mlp_cln_plain(x, w1, b1, w2, b2, scale, shift, eps)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_cln: unsupported device {x.device}")
    x2 = x.reshape(-1, x.shape[-1])
    m, c, f, kernel = _check(x2, w1, b1, w2, b2)
    name = _tail_library(kernel)
    _check_tail(x, scale, shift)
    out = torch.empty_like(x2)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if name == "mlp_cln_general":
        return _cln_general_fwd(x, x2, w1, b1, w2, b2, scale, shift, eps, out, m, c, f, stream)
    lib = _build.load(name, _CLN_SIGNATURES)
    _build.launch(lib, "mlp_cln_fwd", x.device, x2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), m, c, f,
        x.shape[1], float(eps), stream)
    mlp_cln.launches += 1
    return out.reshape(x.shape)


def _cln_general_scratch(lib, bwd, m, c, f, l, r, fp32, plan, device):
    """The general tail kernels' scratch for a call under ``plan`` (the
    packed plan of :func:`tail_plan`): the weight copies or item images, and
    the backward's intermediates and partial sums."""
    nbytes = ctypes.c_longlong(0)
    err = lib.mlp_cln_general_scratch(bwd, m, c, f, l, r, fp32, ctypes.addressof(plan),
                                      ctypes.addressof(nbytes))
    return _scratch_buffer(lib, err, nbytes, device)


def _pack_plan(part: dict):
    """One direction of :func:`tail_plan` as the C entries take it: [path,
    NH, KC, kp, x resident, u kept, NS, row tiles a CTA] (path 1: the
    row-tile kernel)."""
    if part["kernel"] != "tail_rows":
        return (ctypes.c_int * 8)()
    return (ctypes.c_int * 8)(1, part["nh"], part["kc"], part["kp"], part["xres"],
                              part["ukeep"], part["ns"], part["rows"])


def _aligned_rows(x2, part):
    """x as the row-tile kernel reads it: where the plan streams x's chunks
    by bulk copies, a 16-byte aligned copy of a misaligned x."""
    if part["kernel"] == "tail_rows" and not part["xres"] and x2.data_ptr() % 16:
        return x2.clone()
    return x2


def _cln_general_fwd(x, x2, w1, b1, w2, b2, scale, shift, eps, out, m, c, f, stream):
    """The general tail forward's launch (``csrc/mlp_cln_general.cu``)."""
    lib = _build.load("mlp_cln_general", _CLN_GENERAL_SIGNATURES)
    fp32 = int(x.dtype == torch.float32)
    part = tail_plan(m, c, f, x.dtype)["fwd"]
    plan = _pack_plan(part)
    x2 = _aligned_rows(x2, part)
    scratch = _cln_general_scratch(lib, 0, m, c, f, x.shape[1], 0, fp32, plan, x.device)
    _build.launch(lib, "mlp_cln_general_fwd", x.device, x2.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), m, c, f, x.shape[1], float(eps), fp32,
        ctypes.addressof(plan), stream)
    mlp_cln.launches_general += 1
    return out.reshape(x.shape)


def _cln_general_bwd(x, x2, w1, b1, w2, b2, scale, eps, dy2, m, c, f, stream):
    """The general tail backward's launch (``csrc/mlp_cln_general.cu``):
    (dx, dw1, db1, dw2, db2, dscale, dshift)."""
    b = x.shape[0]
    r = general_bwd_splits(m, c, f)
    fp32 = int(x.dtype == torch.float32)
    part = tail_plan(m, c, f, x.dtype)["bwd"]
    plan = _pack_plan(part)
    x2 = _aligned_rows(x2, part)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x2)
    # dw1 | dw2 | db1, and C floats that the general MLP's path writes, unused
    grads = torch.empty(2 * f * c + f + (0 if part["kernel"] == "tail_rows" else c), **f32)
    cout = torch.empty(c + 2 * b * c, **f32)       # db2 | dscale | dshift
    lib = _build.load("mlp_cln_general", _CLN_GENERAL_SIGNATURES)
    scratch = _cln_general_scratch(lib, 1, m, c, f, x.shape[1], r, fp32, plan, x.device)
    _build.launch(lib, "mlp_cln_general_bwd", x.device, x2.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), scale.data_ptr(), dy2.data_ptr(),
        dx.data_ptr(), grads.data_ptr(), cout.data_ptr(), scratch.data_ptr(), m, c, f,
        x.shape[1], r, float(eps), fp32, ctypes.addressof(plan), stream)
    mlp_cln_bwd.launches_general += 1
    return _cln_grads(dx, grads, cout, x.shape, b, c, f)


def mlp_cln_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor, scale: torch.Tensor, eps: float, dy: torch.Tensor):
    """The backward of :func:`mlp_cln` for the output cotangent ``dy``:
    (dx, dw1, db1, dw2, db2, dscale, dshift); see :func:`mlp_cln_bwd_plain`."""
    if x.device.type == "cpu":
        return mlp_cln_bwd_plain(x, w1, b1, w2, b2, scale, eps, dy)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_cln_bwd: unsupported device {x.device}")
    x2 = x.reshape(-1, x.shape[-1])
    dy2 = dy.reshape(-1, dy.shape[-1])
    m, c, f, kernel = _check(x2, w1, b1, w2, b2)
    name = _tail_library(kernel)
    _check_tail(x, scale)
    _check_dy(dy2, x2, kernel)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if name == "mlp_cln_general":
        return _cln_general_bwd(x, x2, w1, b1, w2, b2, scale, eps, dy2, m, c, f, stream)
    b = x.shape[0]
    n_out = 2 * f * c + f + c
    f32 = dict(dtype=torch.float32, device=x.device)
    r = bwd_splits(m, c, f)
    dob = torch.empty_like(x2)            # bf16(do), the MLP backward's cotangent
    dx = torch.empty_like(x2)
    grads = torch.empty(n_out, **f32)     # dw1 | dw2 | db1 | sum of bf16(do), unused
    part = torch.empty((r, n_out), **f32)
    cpart = torch.empty((m // 64, 3, c), **f32)
    cout = torch.empty(c + 2 * b * c, **f32)  # db2 | dscale | dshift
    lib = _build.load("mlp_cln_bwd", _CLN_BWD_SIGNATURES)
    _build.launch(lib, "mlp_cln_bwd", x.device, x2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), scale.data_ptr(), dy2.data_ptr(), dob.data_ptr(),
        dx.data_ptr(), grads.data_ptr(), part.data_ptr(), cpart.data_ptr(), cout.data_ptr(), m, c,
        f, x.shape[1], r, float(eps), stream)
    mlp_cln_bwd.launches += 1
    return _cln_grads(dx, grads, cout, x.shape, b, c, f)


def _cln_grads(dx, grads, cout, x_shape, b, c, f):
    """(dx, dw1, db1, dw2, db2, dscale, dshift) from the tail backward's
    outputs: grads = dw1 | dw2 | db1 (| unused), cout = db2 | dscale |
    dshift."""
    dw1, dw2, db1 = grads[:2 * f * c + f].split([f * c, c * f, f])
    db2, dscale, dshift = cout.split([c, b * c, b * c])
    return (dx.reshape(x_shape), dw1.view(f, c), db1, dw2.view(c, f), db2,
            dscale.view(b, c), dshift.view(b, c))


class MlpClnFn(torch.autograd.Function):
    """Forward through the fused tail kernel (or its plain version on the
    CPU), backward through its backward kernel (or its plain version): the
    ``jax.custom_vjp`` of ``_mlp_cln_core``, with gradients to x, the MLP
    weights and biases, scale and shift."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, scale, shift, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, w1, b1, w2, b2, scale)
        return _forward_cln(x, w1, b1, w2, b2, scale, shift, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2, scale = ctx.saved_tensors
        return (*mlp_cln_bwd(x, w1, b1, w2, b2, scale, ctx.eps, dy.contiguous()), None)


def mlp_cln(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
            b2: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """The fused Swin block tail ``x + scale * cln(mlp(x)) + shift`` of a
    (B, L, C) stream with per-image (B, C) fp32 scale and shift, with its
    backward. ``mlp_cln.launches`` counts forward launches of the Hopper
    kernel, ``mlp_cln_bwd.launches`` backward ones; their
    ``launches_general`` count the general kernel's."""
    return MlpClnFn.apply(x, w1, b1, w2, b2, scale, shift, eps)


def use_fused_tail(c: int, tokens_per_image: int, f: Optional[int] = None) -> bool:
    """The port's gate of the fused block tail: the MLP kernel's rule
    (:func:`use_mlp_kernel`: C <= 1024, F <= 4096, F defaulting to 4C, at
    least 256 tokens an image) and whole 64-row tiles per image, in either
    dtype and on either device. On the card the tail's Hopper kernels take
    bf16 with C in ``KERNEL_WIDTHS`` and F % 64 == 0 and its general kernels
    every other such block (fp32, F = 3C, other widths:
    :func:`mlp_kernel_for`); on the CPU its plain version takes them all.
    Any other block runs the unfused branch (the MLP kernel or two GEMMs,
    and the plain norm), which computes the same function. At ScOT-T/S and
    ScOT-B on 128x128 inputs this picks stages 0-1, the blocks where the
    JAX package's TPU VMEM budget (``dm_eligible(..., cln=True)``) also
    takes its kernel, in bf16 and fp32, but for ScOT-B stage 0 in fp32,
    which that budget refuses by 0.2 MB. At ScOT-L the budget refuses every
    stage and this rule takes stages 0-1. Both paths compute the same
    function, so only the speed differs."""
    f = 4 * c if f is None else f
    return use_mlp_kernel(c, tokens_per_image, f) and tokens_per_image % 64 == 0


# The row-tile path of the general tail (csrc/mlp_cln_rows.cuh): its
# kernel's dynamic shared memory at most, the SMs of the card it is planned
# for, and the widest C it takes. A warpgroup holds one of GENERAL_WIDTHS
# output columns.
TAIL_SMEM = 232448
H100_SMS = 132
TAIL_MAX_C = 384


def _align1k(n: int) -> int:
    return (n + 1023) // 1024 * 1024


def _step(nh: int, rows: int) -> int:
    """Hidden columns a step of the row-tile kernel walks: a warpgroup's
    ``cln_rows::FT`` = 32, both warpgroups' with one row tile a CTA."""
    return 32 * (1 if rows == 2 else 2)


def _rows_layout(c: int, f: int, fp32: bool, bwd: bool, nh: int, kc: int, kp: int, xres: int,
                 ukeep: int, ns: int, rows: int) -> int:
    """Dynamic shared-memory bytes of the row-tile kernel under one plan, as
    ``cln_rows::make_layout`` lays it out: x (resident), cast(do)
    (backward), two g / du tiles, u (kept), the row-sum exchange, NS ring
    slots and the mbarriers; ``rows`` row tiles of 64 a CTA."""
    eb, parts = (4, 2) if fp32 else (2, 1)
    fs, cp, cpo = _step(nh, rows), -(-c // 16) * 16, nh * (1 if rows == 2 else 2)
    fpad = -(-f // 64) * 64

    def stride(k):  # words a raw row of k elements takes
        return k * eb // 4 + 4

    def tile(n, k):  # one swizzled image of n rows, hi and lo parts for fp32
        return parts * _align1k(n * k * eb)

    at = _align1k(64 * rows * stride(cp) * 4) if xres else 0
    at += _align1k(64 * rows * stride(cp) * 4) if bwd else 0
    at += 2 * _align1k(64 * stride(fs) * 4)
    at += _align1k(64 * rows * fpad * 4) if ukeep else 0
    at += 2048
    item1 = tile(fs, kc) + (0 if xres else _align1k(64 * stride(kc) * 4))
    slot = _align1k(max(item1, tile(cpo, kp)))
    return at + ns * slot + 64


def _rows_plan(c: int, f: int, fp32: bool, bwd: bool, rows: int):
    """The row-tile kernel's plan for one direction with ``rows`` row tiles
    a CTA, or None where none fits: x resident where it fits (else, with
    one row tile, its chunks stream beside the W1 chunks, where C is whole
    16-byte rows), then the widest items (W1 or W2^T chunks of KC columns
    of C, W2 or W1^T pieces of kp hidden columns) that leave at least three
    ring slots (two where three do not fit), at most four; for the
    backward, u kept in shared memory where it fits beside the same items
    and at least as many slots (three at most)."""
    eb, ks = (4, 8) if fp32 else (2, 16)
    nh = next((n for n in GENERAL_WIDTHS if n * (1 if rows == 2 else 2) >= c), None)
    if nh is None or (rows == 2 and nh > 96):
        return None
    cp, fs = -(-c // 16) * 16, _step(nh, rows)
    cpo = nh * (1 if rows == 2 else 2)
    parts = 2 if fp32 else 1
    kcs = [cp] + [k for k in range(cp - 16, 15, -16)]
    kps = [k for k in (fs, fs // 2, fs // 4, fs // 8) if k >= ks]
    streamable = rows == 1 and cp == c and (c * eb) % 16 == 0
    for min_ns in (3, 2):
        for xres in ((1, 0) if streamable else (1,)):
            for cap in (49152, 32768, 24576, 16384, 12288, 8192):
                kc = next((k for k in kcs if parts * _align1k(fs * k * eb)
                           + (0 if xres else _align1k(64 * (k * eb // 4 + 4) * 4)) <= cap), None)
                kp = next((k for k in kps if parts * _align1k(cpo * k * eb) <= cap), None)
                if kc is None or kp is None or (not xres and (kc * eb) % 16):
                    continue

                def fit(ukeep, ns):
                    return _rows_layout(c, f, fp32, bwd, nh, kc, kp, xres, ukeep, ns,
                                        rows) <= TAIL_SMEM

                ns = max([n for n in (2, 3, 4) if fit(0, n)], default=0)
                if ns < min_ns:
                    continue
                ukeep = int(bwd and fit(1, min(ns, 3)))
                if ukeep:
                    ns = max(n for n in (2, 3, 4) if fit(1, n))
                return {"kernel": "tail_rows", "rows": rows, "nh": nh, "kc": kc, "kp": kp,
                        "xres": xres, "ukeep": ukeep, "ns": ns,
                        "smem": _rows_layout(c, f, fp32, bwd, nh, kc, kp, xres, ukeep, ns, rows)}
    return None


@functools.lru_cache(maxsize=None)
def tail_plan(m: int, c: int, f: int, dtype: torch.dtype) -> dict:
    """The plan of the general tail kernels (``csrc/mlp_cln_general.cu``)
    for M rows of width C and hidden width F in ``dtype``, the one the C
    entries take (as :func:`_pack_plan` packs it), by direction:

    - ``kernel``: ``"tail_rows"``, the row-tile kernel (``mlp_cln_rows.cuh``:
      64 whole rows a CTA, two warpgroups splitting each step's hidden
      columns and the output columns, u once a row, no fp32 partials of o),
      at C <= 384, but for the forward where the general MLP's forward
      kernel holds whole rows in one warpgroup and fills the card without
      splitting F (C <= 192 and M / 128 >= the card's 132 SMs; the row-tile
      forward, 64 rows a CTA, measured 2-32% slower there, PERF.md): there
      ``"mlp_general"``, the general MLP's forward with the norm in its
      epilogue, as at C > 384 (two or more column blocks: fp32 partials of o
      and a row kernel; the backward there recomputes the forward and runs
      the general MLP's backward), and as the backward at fp32 C in (272,
      384) off a multiple of 16, where no row-tile layout fits.
    - for ``"tail_rows"``: ``nh`` (output columns a warpgroup holds), ``kc``
      and ``kp`` (the ring items' widths), ``xres`` (x resident in shared
      memory, else streamed beside the W1 chunks), ``ukeep`` (backward: u
      kept in shared memory from the first walk to the second, else
      recomputed), ``ns`` (ring slots), ``smem`` (dynamic shared memory),
      ``ctas`` (M / 64), ``u_products`` (times u = x W1^T is computed a row:
      1, or 2 where the backward recomputes it), ``f_split`` (always 1).
    - ``device_kernels``: launches of one call on the card: 2 for the
      forward (prologue, kernel), 4 for the row-tile backward (prologue,
      rows, weights, reduce); for ``"mlp_general"`` the forward's 2 (3 with
      a row kernel at C > 192) and None for its backward (8, or 9 where the
      MLP backward splits F: that plan is the C side's).
    """
    fp32 = dtype == torch.float32
    out = {}
    whole = m % 128 == 0 and m // 128 >= H100_SMS  # 128-row CTAs fill the card
    for bwd in (False, True):
        plan = None
        if c <= TAIL_MAX_C:
            plan = (_rows_plan(c, f, fp32, bwd, 2) if bwd and whole and c <= 96 else None) \
                or _rows_plan(c, f, fp32, bwd, 1)
        if plan is not None and not bwd and c <= 192 and m // 128 >= H100_SMS:
            plan = None
        if plan is None:
            part = {"kernel": "mlp_general", "device_kernels": None if bwd else
                    (3 if c > 192 or m // 128 < H100_SMS else 2)}
        else:
            part = dict(plan, ctas=m // (64 * plan["rows"]), f_split=1,
                        u_products=2 if bwd and not plan["ukeep"] else 1,
                        device_kernels=4 if bwd else 2)
        out["bwd" if bwd else "fwd"] = part
    return out


mlp_cln.launches = 0
mlp_cln_bwd.launches = 0
mlp_cln.launches_general = 0
mlp_cln_bwd.launches_general = 0
_F = ctypes.c_float
# x, w1, b1, w2, b2, scale, shift, out, M, C, F, L, eps, stream
_CLN_SIGNATURES = {"mlp_cln_fwd": (_P,) * 8 + (_I,) * 4 + (_F, _P), "mlp_cln_fwd_info": (_I, _P)}
# x, w1, b1, w2, b2, scale, dy, dob, dx, grads, part, cpart, cout, M, C, F, L, R, eps, stream
_CLN_BWD_SIGNATURES = {"mlp_cln_bwd": (_P,) * 13 + (_I,) * 5 + (_F, _P),
                       "mlp_cln_bwd_info": (_I, _P)}
_CLN_GENERAL_SIGNATURES = {
    # x, w1, b1, w2, b2, scale, shift, out, scratch, M, C, F, L, eps, fp32, plan, stream
    "mlp_cln_general_fwd": (_P,) * 9 + (_I,) * 4 + (_F, _I, _P, _P),
    # x, w1, b1, w2, b2, scale, dy, dx, grads, cout, scratch, M, C, F, L, R, eps, fp32, plan,
    # stream
    "mlp_cln_general_bwd": (_P,) * 11 + (_I,) * 5 + (_F, _I, _P, _P),
    # bwd, M, C, F, L, R, fp32, plan, long long out: scratch bytes
    "mlp_cln_general_scratch": (_I,) * 7 + (_P, _P),
    # kernel, fp32, width, int[3] out: registers, spill bytes, shared-memory bytes
    "mlp_cln_general_info": (_I, _I, _I, _P),
    # bwd, C, F, fp32, plan, long long out: the row-tile kernel's shared-memory bytes
    "mlp_cln_general_layout": (_I, _I, _I, _I, _P, _P),
}
# Widths at which the general tail's row kernels are reported: one a class
# of values a lane holds (C <= 128, 256, 512, 1024).
CLN_ROW_WIDTHS = (128, 256, 512, 1024)
