"""The conditional LayerNorm as one kernel forward and two backward: the
Hopper kernels' wrappers (``csrc/cond_layer_norm.cu``), their plain PyTorch
version, the autograd Function that joins them, and the rule of which
operands they take.

Over the last axis (width C) of x, with the lead time ``t[b]`` of the row's
image b and the ``Linear(1, C)`` maps ``(w_scale, b_scale)`` and
``(w_shift, b_shift)`` of the lead time (fp32)::

    mu = mean_C x,  v = mean_C x^2 - mu^2,  r = rsqrt(max(v, 0) + eps)    (fp32)
    y  = cast((t[b] w_scale + b_scale) (x - mu) r + (t[b] w_shift + b_shift))

rounded once to x's dtype: ``models/layers.py::ConditionalLayerNorm``'s
chain. The forward saves x, t and the rows' fp32 ``mean`` and ``rstd`` (r,
negative where v < 0: the clamp passes no gradient through v there); the
backward returns dx in x's dtype and the four parameter gradients, summed
over the rows of each image and weighted by its t (:func:`cond_layer_norm_bwd_plain`).

A CPU tensor goes to the plain version. A CUDA tensor goes to the kernels
or raises (:func:`_operands`): they take a bf16 or fp32 x ``(B, ..., C)``
with C a whole number of 16-byte vectors and C <= 1536, any number of rows
an image, fp32 maps, and a lead time per image that needs no gradient;
:func:`cond_layer_norm` makes x contiguous and 16-byte aligned first.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .mlp import H100_SMS

MAX_C = 1536


def _affine(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t[b] w + b`` (fp32) shaped to broadcast over x's rows of image b."""
    bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return (t.float()[:, None] * w.reshape(1, -1) + b).reshape(bshape)


def cond_layer_norm_plain(x: torch.Tensor, t: torch.Tensor, w_scale: torch.Tensor,
                          b_scale: torch.Tensor, w_shift: torch.Tensor, b_shift: torch.Tensor,
                          eps: float):
    """Plain PyTorch version of the forward kernel: (y, mean, rstd), mean
    and rstd fp32 of x's leading shape, rstd negative where the variance
    clamps."""
    xf = x.float()
    mean = xf.mean(-1)
    var = (xf * xf).mean(-1) - mean * mean
    r = torch.rsqrt(var.clamp(min=0.0) + eps)
    xhat = (xf - mean[..., None]) * r[..., None]
    y = _affine(t, w_scale, b_scale, x) * xhat + _affine(t, w_shift, b_shift, x)
    return y.to(x.dtype), mean, torch.where(var < 0, -r, r)


def cond_layer_norm_bwd_plain(x: torch.Tensor, t: torch.Tensor, w_scale: torch.Tensor,
                              b_scale: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                              dy: torch.Tensor):
    """Plain PyTorch version of the backward kernels, by their formulas: with
    ``g = dy scale`` and ``xhat = (x - mean) |rstd|`` in fp32,

        dx = cast(|rstd| (g - mean_C g - xhat mean_C(g xhat)))   (no last term where rstd < 0)

    and, through the per-image sums ``ds[b] = sum_rows(b) dy xhat`` and
    ``dh[b] = sum_rows(b) dy``: ``dw_scale = sum_b t[b] ds[b]``, ``db_scale =
    sum_b ds[b]``, and the same with dh for the shift. Returns (dx, dw_scale
    (C, 1), db_scale, dw_shift (C, 1), db_shift)."""
    c = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    r = rstd.abs()[..., None]
    xhat = (xf - mean[..., None]) * r
    g = dyf * _affine(t, w_scale, b_scale, x)
    mgx = torch.where(rstd[..., None] < 0, 0.0, (g * xhat).mean(-1, keepdim=True))
    dx = (r * (g - g.mean(-1, keepdim=True) - xhat * mgx)).to(x.dtype)
    b = x.shape[0]
    ds = (dyf * xhat).reshape(b, -1, c).sum(1)
    dh = dyf.reshape(b, -1, c).sum(1)
    tf = t.float()[:, None]
    return (dx, (tf * ds).sum(0)[:, None], ds.sum(0), (tf * dh).sum(0)[:, None], dh.sum(0))


@functools.lru_cache(maxsize=None)
def plan(m: int, c: int, l: int, dtype: torch.dtype, bwd: bool) -> dict:
    """The kernels' plan for M rows of width C, L rows an image, in
    ``dtype``: ``g`` lanes a row (a power of two: about three 16-byte vectors
    a lane, at most a warp, and at least a warp a CTA), ``nv`` vectors a lane
    at most (3, 6 or 12: the kernels' instantiations, 12 only in fp32),
    ``threads`` a CTA
    (``g`` x the groups, at most 256 and no more groups than L rounded up to
    a power of two), and ``rows`` a CTA: the groups times the largest power
    of two, up to 16 rows a group, that fits in that rounded L and leaves at
    least four CTAs an SM for the forward and two for the backward (whose
    CTAs each write one (2, C) partial, so fewer of them make its reduce
    shorter); ``tiles_per_image`` (ceil(L / rows): an image's last tile may
    be short) and ``tiles`` (CTAs)."""
    nvec = c // (8 if dtype == torch.bfloat16 else 4)
    span = 1 << (l - 1).bit_length()  # L rounded up to a power of two
    g = 1
    while g < 32 and 3 * g < nvec:
        g *= 2
    g = max(g, 32 // min(span, 32))
    groups = min(256 // g, span)
    need = -(-nvec // g)
    nv = 3 if need <= 3 else 6 if need <= 6 else 12
    target = H100_SMS * (2 if bwd else 4)
    images = m // l
    k = 1
    while k < 16 and groups * 2 * k <= span and images * -(-l // (groups * 2 * k)) >= target:
        k *= 2
    rows = groups * k
    per = -(-l // rows)
    return {"g": g, "nv": nv, "threads": groups * g, "rows": rows, "tiles": images * per,
            "tiles_per_image": per}


def _operands(x, t, *maps):
    """Raises where the kernels do not take the operands (a contiguous,
    16-byte aligned bf16 or fp32 x of at least two dims with C a whole
    number of 16-byte vectors and C <= MAX_C, fp32 contiguous aligned maps
    of C values, a lead time of one value an image that needs no gradient,
    all on x's device); returns (M, C, L)."""
    def refuse(why):
        raise ValueError(f"cond_layer_norm kernels: {why}; x {tuple(x.shape)} {x.dtype}")

    if x.dtype not in (torch.bfloat16, torch.float32):
        refuse("x must be bf16 or fp32")
    if x.ndim < 2 or x.numel() == 0 or not x.is_contiguous() or x.data_ptr() % 16:
        refuse("x must be a non-empty contiguous (B, ..., C), 16-byte aligned")
    c = x.shape[-1]
    if c % (8 if x.dtype == torch.bfloat16 else 4) or c > MAX_C:
        refuse(f"C must be whole 16-byte vectors and at most {MAX_C}")
    if t.numel() != x.shape[0] or t.requires_grad or t.device != x.device:
        refuse("the lead time must be one value an image on x's device, needing no gradient")
    for a in maps:
        if a.dtype != torch.float32 or a.numel() != c or not a.is_contiguous() \
                or a.device != x.device or a.data_ptr() % 16:
            refuse("the maps must be fp32, contiguous, 16-byte aligned, of C values on x's "
                   "device")
    return x.numel() // c, c, x.numel() // (x.shape[0] * c)


def _forward(x, t, w_scale, b_scale, w_shift, b_shift, eps):
    if x.device.type == "cpu":
        return cond_layer_norm_plain(x, t, w_scale, b_scale, w_shift, b_shift, eps)
    if x.device.type != "cuda":
        raise ValueError(f"cond_layer_norm: unsupported device {x.device}")
    m, c, l = _operands(x, t, w_scale, b_scale, w_shift, b_shift)
    p = plan(m, c, l, x.dtype, False)
    y = torch.empty_like(x)
    stats = torch.empty((2, m), dtype=torch.float32, device=x.device)
    lib = _build.load("cond_layer_norm", _SIGNATURES)
    _build.launch(lib, "cond_layer_norm_fwd", x.device, x.data_ptr(), t.data_ptr(),
        w_scale.data_ptr(), b_scale.data_ptr(), w_shift.data_ptr(), b_shift.data_ptr(),
        y.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), m, c, l, p["g"], p["nv"],
        p["rows"], p["threads"], float(eps), int(x.dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    cond_layer_norm.launches += 1
    lead = x.shape[:-1]
    return y, stats[0].view(lead), stats[1].view(lead)


def cond_layer_norm_bwd(x: torch.Tensor, t: torch.Tensor, w_scale: torch.Tensor,
                        b_scale: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                        dy: torch.Tensor):
    """The backward of :func:`cond_layer_norm` for the output cotangent
    ``dy``: (dx, dw_scale (C, 1), db_scale, dw_shift (C, 1), db_shift); see
    :func:`cond_layer_norm_bwd_plain`. ``launches`` counts its calls on the
    card (two kernels each)."""
    if x.device.type == "cpu":
        return cond_layer_norm_bwd_plain(x, t, w_scale, b_scale, mean, rstd, dy)
    if x.device.type != "cuda":
        raise ValueError(f"cond_layer_norm_bwd: unsupported device {x.device}")
    m, c, l = _operands(x, t, w_scale, b_scale, w_scale, b_scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("dy must be of x's shape, dtype and device")
    dy = dy.contiguous()
    if dy.data_ptr() % 16:
        dy = dy.clone()
    p = plan(m, c, l, x.dtype, True)
    dx = torch.empty_like(x)
    part = torch.empty((p["tiles"], 2, c), dtype=torch.float32, device=x.device)
    grads = torch.empty(4 * c, dtype=torch.float32, device=x.device)
    lib = _build.load("cond_layer_norm", _SIGNATURES)
    _build.launch(lib, "cond_layer_norm_bwd", x.device, x.data_ptr(), dy.data_ptr(),
        t.data_ptr(), w_scale.data_ptr(), b_scale.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dx.data_ptr(), part.data_ptr(), grads.data_ptr(), m, c, l, p["g"], p["nv"], p["rows"],
        p["threads"], int(x.dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    cond_layer_norm_bwd.launches += 1
    dws, dbs, dwb, dbb = grads.split(c)
    return dx, dws.view(c, 1), dbs, dwb.view(c, 1), dbb


class CondLayerNormFn(torch.autograd.Function):
    """Forward through the forward kernel (or its plain version on the CPU),
    backward through the backward kernels (or their plain version), with
    gradients to x and the four maps; the lead time takes none."""

    @staticmethod
    def forward(ctx, x, t, w_scale, b_scale, w_shift, b_shift, eps):
        y, mean, rstd = _forward(x, t, w_scale, b_scale, w_shift, b_shift, eps)
        ctx.save_for_backward(x, t, w_scale, b_scale, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, t, w_scale, b_scale, mean, rstd = ctx.saved_tensors
        dx, dws, dbs, dwb, dbb = cond_layer_norm_bwd(x, t, w_scale, b_scale, mean, rstd, dy)
        return dx, None, dws.view_as(w_scale), dbs, dwb.view_as(w_scale), dbb, None


def cond_layer_norm(x: torch.Tensor, time: torch.Tensor, w_scale: torch.Tensor,
                    b_scale: torch.Tensor, w_shift: torch.Tensor, b_shift: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """The conditional LayerNorm of x ``(B, ..., C)`` with the per-image lead
    time ``time`` (B values) and the ``Linear(1, C)`` maps' weights (C, 1)
    and biases (C,), with its backward. ``cond_layer_norm.launches`` counts
    forward launches of the kernel, ``cond_layer_norm_bwd.launches`` backward
    calls."""
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return CondLayerNormFn.apply(x, time.reshape(-1).float().contiguous(), w_scale, b_scale,
                                 w_shift, b_shift, eps)


cond_layer_norm.launches = 0
cond_layer_norm_bwd.launches = 0
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, t, ws, bs, wb, bb, y, mean, rstd, M, C, L, G, NV, TR, threads, eps, fp32, stream
    "cond_layer_norm_fwd": (_P,) * 9 + (_I,) * 7 + (_F, _I, _P),
    # x, dy, t, ws, bs, mean, rstd, dx, part, grads, M, C, L, G, NV, TR, threads, fp32, stream
    "cond_layer_norm_bwd": (_P,) * 10 + (_I,) * 8 + (_P,),
    # kernel, fp32, NV, int[3] out: registers, spill bytes, static shared-memory bytes
    "cond_layer_norm_info": (_I, _I, _I, _P),
}


def kernel_info() -> dict:
    """Registers, local-memory (spill) bytes and static shared-memory bytes
    of every instantiation (forward and backward by dtype and NV: 3 and 6,
    and 12 in fp32; and the reduce). Builds and loads the library."""
    fn = _build.load("cond_layer_norm", _SIGNATURES).cond_layer_norm_info
    out = {}
    for kernel, name in ((0, "fwd"), (1, "bwd"), (2, "reduce")):
        for fp32 in ((0, 1) if kernel < 2 else (0,)):
            for nv in ((3, 6, 12) if kernel < 2 and fp32 else (3, 6) if kernel < 2 else (3,)):
                vals = (ctypes.c_int * 3)()
                err = fn(kernel, fp32, nv, ctypes.addressof(vals))
                if err != 0:
                    raise RuntimeError(f"cond_layer_norm info failed: {err}")
                key = f"cond_layer_norm {name}" + (
                    f" {'fp32' if fp32 else 'bf16'} NV={nv}" if kernel < 2 else "")
                out[key] = {"registers": vals[0], "spill_bytes": vals[1],
                            "smem_bytes": vals[2]}
    return out
