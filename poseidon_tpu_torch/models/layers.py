"""Building-block layers of the PyTorch scOT.

Token tensors are ``(B, L, C)`` and images NHWC, as in the JAX package, so
each layer can be held to its flax counterpart on the same inputs. Weights
are fp32 and are cast to the compute dtype at use; parameter names and
shapes are those of the reference PyTorch state dict (see ``hub.py``).
Patch embedding and recovery run as reshape + GEMM.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, the reference's ``ACT2FN['gelu']``."""
    return F.gelu(x, approximate="none")


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` in x's dtype, with the fp32 parameters cast
    to it first (flax ``Dense(dtype=...)`` semantics)."""
    y = x @ weight.to(x.dtype).t()
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def _layer_stats(x: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 ``(x - mean) * rsqrt(var + eps)`` over the last dim, with the
    clamped ``E[x^2] - mean^2`` variance (negative round-off would NaN)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (xf - mean) * torch.rsqrt(var + eps)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Element dropout with flax ``nn.Dropout`` semantics: each element kept
    with probability 1 - rate and scaled by 1/(1 - rate). Active only in
    train mode with rate > 0. The mask is drawn from ``generator`` on the
    generator's device (x's device when None)."""
    if rate == 0.0 or not training:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    dev = x.device if generator is None else generator.device
    mask = (torch.rand(x.shape, generator=generator, device=dev) < keep).to(x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Per-sample stochastic depth, scaled by 1/keep_prob. Active only in
    train mode; the caller passes the generator that draws the mask."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def keep_factor(self, batch: int,
                    generator: Optional[torch.Generator] = None) -> Optional[torch.Tensor]:
        """(batch,) fp32 keep mask / keep, drawn as ``forward`` draws it on
        the generator's device (the CPU when None), or None when inactive.
        The fused block tail folds it into its per-sample scale and shift."""
        if self.rate == 0.0 or not self.training:
            return None
        keep = 1.0 - self.rate
        dev = "cpu" if generator is None else generator.device
        u = torch.rand((batch,), generator=generator, device=dev)
        return (u < keep).float() / keep

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        factor = self.keep_factor(x.shape[0], generator)
        if factor is None:
            return x
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = (factor > 0).reshape(shape).to(x.device)
        return torch.where(mask, x / (1.0 - self.rate), torch.zeros_like(x))


class ConditionalLayerNorm(nn.Module):
    """Lead-time-conditioned LayerNorm: no learned affine of its own, then
    ``y = W_s(t) * x_hat + W_b(t)``. ``weight``/``bias`` are Linear(1, C)
    maps of the scalar lead time, as in the reference state dict.

    Under ``impl="pallas"`` a CUDA x goes to the kernels
    (``ops/norm.py::cond_layer_norm``, which raises for operands they do
    not take); the chain below is the plain path they are held to."""

    def __init__(self, dim: int, eps: float = 1e-5, impl: str = "xla"):
        super().__init__()
        self.eps = eps
        self.impl = impl
        self.weight = nn.Linear(1, dim)
        self.bias = nn.Linear(1, dim)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor]) -> torch.Tensor:
        if self.impl == "pallas" and x.is_cuda:
            from ..ops import norm  # here: the ops package imports this module

            return norm.cond_layer_norm(x, time, self.weight.weight, self.weight.bias,
                                        self.bias.weight, self.bias.bias, self.eps)
        y = _layer_stats(x, self.eps)
        t = time.reshape(-1, 1).float()
        scale = F.linear(t, self.weight.weight, self.weight.bias)
        shift = F.linear(t, self.bias.weight, self.bias.bias)
        bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        y = scale.reshape(bshape) * y + shift.reshape(bshape)
        return y.to(x.dtype)


class PlainLayerNorm(nn.Module):
    """LayerNorm with flax's numerics (fp32 stats, fast variance) and the
    uniform ``(x, time)`` signature. Output in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor]) -> torch.Tensor:
        del time
        return (_layer_stats(x, self.eps) * self.weight + self.bias).to(self.dtype)


def make_norm(use_conditioning: bool, dim: int, eps: float, dtype: torch.dtype,
              impl: str = "xla") -> nn.Module:
    """The block norm: conditional (on ``impl``'s path) or plain."""
    if use_conditioning:
        return ConditionalLayerNorm(dim, eps, impl)
    return PlainLayerNorm(dim, eps, dtype)


class PatchEmbed(nn.Module):
    """Patchify + linear projection as a reshape + GEMM. Token (i, j) is the
    flattened (p, p, C_in) patch in (dy, dx, c) order. ``projection`` keeps
    the reference's Conv2d shape (E, C_in, p, p)."""

    def __init__(self, patch_size: int, num_channels: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.projection = nn.Conv2d(num_channels, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, H, W, C) -> (B, L, E)
        b, h, w, c = x.shape
        p = self.patch_size
        if h % p or w % p:
            x = F.pad(x, (0, 0, 0, -w % p, 0, -h % p))
            h, w = x.shape[1], x.shape[2]
        gh, gw = h // p, w // p
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c).to(self.dtype)
        wk = self.projection.weight.permute(2, 3, 1, 0).reshape(p * p * c, -1)
        return x @ wk.to(self.dtype) + self.projection.bias.to(self.dtype)


class _ConvTransposeParams(nn.Module):
    """Holds a ConvTranspose2d(E -> C_out, kernel=stride=p)-shaped weight
    (E, C_out, p, p) and bias (C_out,)."""

    def __init__(self, embed_dim: int, out_channels: int, patch_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(embed_dim, out_channels, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))


class PatchRecovery(nn.Module):
    """Inverse of PatchEmbed: per-token GEMM to a (p, p, C_out) block
    (== ConvTranspose with kernel=stride=patch), its bias added before the
    un-patchify, then a bias-free 5x5 mixup conv."""

    def __init__(self, patch_size: int, embed_dim: int, num_out_channels: int,
                 grid_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.grid_size = grid_size
        self.dtype = dtype
        self.projection = _ConvTransposeParams(embed_dim, num_out_channels, patch_size)
        self.mixup = nn.Conv2d(num_out_channels, num_out_channels, 5, padding=2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, L, E) -> (B, H, W, C_out)
        b = x.shape[0]
        p, g = self.patch_size, self.grid_size
        w = self.projection.weight
        co = w.shape[1]
        wk = w.permute(0, 2, 3, 1).reshape(w.shape[0], p * p * co)
        x = x.to(self.dtype) @ wk.to(self.dtype)
        x = x.reshape(b, g, g, p, p, co) + self.projection.bias.to(self.dtype)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * p, g * p, co)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.mixup.weight.to(self.dtype), padding=2)
        return y.permute(0, 2, 3, 1)


class PatchMerging(nn.Module):
    """2x downsample: gather the 4 neighbours -> Linear(4C -> 2C, no bias)
    -> norm (reduction before norm)."""

    def __init__(self, dim: int, input_resolution: int, use_conditioning: bool,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32, impl: str = "xla"):
        super().__init__()
        self.input_resolution = input_resolution
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = make_norm(use_conditioning, 2 * dim, eps, dtype, impl)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor]) -> torch.Tensor:
        b, _, c = x.shape
        h = w = self.input_resolution
        x = x.reshape(b, h, w, c)
        # Quadrant order (even, even), (odd, even), (even, odd), (odd, odd).
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(b, (h // 2) * (w // 2), 4 * c)
        return self.norm(dense(x, self.reduction.weight), time)


class PatchUnmerging(nn.Module):
    """2x upsample: Linear(C -> 2C, no bias) -> pixel-shuffle to
    (2H, 2W, C/2) -> norm -> bias-free Linear(C/2 -> C/2) mixup."""

    def __init__(self, dim: int, input_resolution: int, use_conditioning: bool,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32, impl: str = "xla"):
        super().__init__()
        self.input_resolution = input_resolution
        self.upsample = nn.Linear(dim, 2 * dim, bias=False)
        self.mixup = nn.Linear(dim // 2, dim // 2, bias=False)
        self.norm = make_norm(use_conditioning, dim // 2, eps, dtype, impl)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor]) -> torch.Tensor:
        b, _, c = x.shape
        h = w = self.input_resolution
        x = dense(x, self.upsample.weight)
        x = x.reshape(b, h, w, 2, 2, c // 2).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, 4 * h * w, c // 2)
        x = self.norm(x, time)
        return dense(x, self.mixup.weight)


class ConvNeXtBlock(nn.Module):
    """Residual skip block: 7x7 depthwise conv -> norm -> Linear(C -> 4C) ->
    GELU -> Linear(4C -> C) -> layer scale (init 1e-6) -> residual."""

    def __init__(self, dim: int, use_conditioning: bool, eps: float = 1e-5,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32, impl: str = "xla"):
        super().__init__()
        self.dtype = dtype
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = make_norm(use_conditioning, dim, eps, dtype, impl)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.weight = nn.Parameter(torch.full((dim,), 1e-6))  # layer scale
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, l, c = x.shape
        side = math.isqrt(l)
        h = x.reshape(b, side, side, c).permute(0, 3, 1, 2).to(self.dtype)
        h = F.conv2d(h, self.dwconv.weight.to(self.dtype),
                     self.dwconv.bias.to(self.dtype), padding=3, groups=c)
        h = h.permute(0, 2, 3, 1)
        h = self.norm(h, time)
        h = gelu_exact(dense(h, self.pwconv1.weight, self.pwconv1.bias))
        h = dense(h, self.pwconv2.weight, self.pwconv2.bias)
        h = h * self.weight.to(h.dtype)
        return x + self.drop_path(h.reshape(b, l, c), generator)


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis with flax's numerics and the
    reference's parameter names (weight, bias, running_mean, running_var;
    no batch counter). Eval uses the running statistics.

    ``process_group`` (set by the Trainer under data parallelism): the
    group over which the batch is split. The train-mode statistics are then
    those of the whole batch, as flax's BatchNorm computes them under the
    JAX mesh: the sums are all-reduced over the group, with autograd through
    the reduction, so the running statistics agree on every rank and the
    gradients are those of the whole batch."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.process_group = None
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.float()
            axes = tuple(range(x.ndim - 1))
            group = self.process_group
            if group is not None and dist.get_world_size(group) > 1:
                from torch.distributed.nn.functional import all_reduce

                sums = torch.cat([xf.sum(axes), (xf * xf).sum(axes)])
                sums = all_reduce(sums, group=group)
                count = float(xf[..., 0].numel() * dist.get_world_size(group))
                mean, mean_sq = (sums / count).chunk(2)
            else:
                mean, mean_sq = xf.mean(axes), (xf * xf).mean(axes)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x.float() - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class ResNetBlock(nn.Module):
    """Alternative residual skip block: two 3x3 convs with BatchNorm and
    leaky-ReLU, residual add."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1)
        self.bn1 = BatchNorm(dim)
        self.bn2 = BatchNorm(dim)

    def _conv(self, h: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        y = F.conv2d(h.permute(0, 3, 1, 2), conv.weight.to(self.dtype),
                     conv.bias.to(self.dtype), padding=1)
        return y.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del time, generator
        b, l, c = x.shape
        side = math.isqrt(l)
        h = x.reshape(b, side, side, c).to(self.dtype)
        h = F.leaky_relu(self.bn1(self._conv(h, self.conv1)), negative_slope=0.01)
        h = self.bn2(self._conv(h, self.conv2))
        return x + h.reshape(b, l, c)
