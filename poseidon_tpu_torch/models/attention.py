"""Shifted-window cosine attention with a log-spaced continuous relative
position bias (SwinV2-style), the mixing op of scOT.

- Cosine attention with a learned per-head logit scale clamped at log(100);
  the key projection has no bias.
- log-CPB: relative coordinates normalised to +-8, then
  sign*log2(|x|+1)/log2(8), through Linear(2, 512) -> ReLU ->
  Linear(512, heads, no bias), gathered to (heads, T, T), 16*sigmoid.
- Shifted windows: an additive -100 mask that the reference adds twice,
  reproduced as one 2x add.

The window geometry depends only on (H, W, window, shift) and is built once
with numpy.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.window_attention import window_attention
from .layers import dropout

# ---------------------------------------------------------------------------
# Static geometry (numpy; cached per window configuration)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def relative_coords_table(window_size: int) -> np.ndarray:
    """Log-spaced normalised relative-coordinate table, shape
    ((2w-1)*(2w-1), 2), the CPB MLP's input."""
    w = window_size
    coords = np.arange(-(w - 1), w, dtype=np.float32)
    table = np.stack(np.meshgrid(coords, coords, indexing="ij"), axis=-1)
    if w > 1:
        table = table / (w - 1)
    table = table * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.reshape(-1, 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def relative_position_index(window_size: int) -> np.ndarray:
    """(T, T) index into the flattened (2w-1)^2 bias table, T = w*w."""
    w = window_size
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(height: int, width: int, window: int,
                        shift: int) -> Optional[np.ndarray]:
    """Additive mask (num_windows, T, T) of the cyclic-shift scheme: 0 within
    a contiguous region, -100 across regions. None when shift == 0."""
    if shift == 0:
        return None
    img = np.zeros((height, width), dtype=np.float32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(height // window, window, width // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = img[:, None, :] - img[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, window*window, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, height: int, width: int) -> torch.Tensor:
    """(B*nW, window*window, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    nh, nw = height // window, width // window
    x = x.reshape(-1, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, height, width, c)


# ---------------------------------------------------------------------------
# Attention module
# ---------------------------------------------------------------------------

class _SelfAttention(nn.Module):
    """Parameters of the reference's ``attention.self``: q/k/v projections,
    the per-head logit scale and the CPB MLP."""

    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool):
        super().__init__()
        self.query = nn.Linear(dim, dim, bias=qkv_bias)
        self.key = nn.Linear(dim, dim, bias=False)
        self.value = nn.Linear(dim, dim, bias=qkv_bias)
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.continuous_position_bias_mlp = nn.Sequential(
            nn.Linear(2, 512), nn.ReLU(), nn.Linear(512, num_heads, bias=False))
        self.register_buffer(
            "relative_coords_table",
            torch.from_numpy(relative_coords_table(window_size)), persistent=False)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size)), persistent=False)


class _SelfOutput(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dense = nn.Linear(dim, dim)


class WindowAttention(nn.Module):
    """Cosine attention over flattened windows.

    Input (num_windows_total, T, C), T = window_size**2, windows of one image
    contiguous. ``mask`` is the additive (num_windows_per_image, T, T) shift
    mask (not yet doubled), or None for unshifted blocks. In train mode the
    attention probabilities and the output projection take dropout
    (``attn_drop``, ``proj_drop``, masks from the caller's generator); the
    kernel path has no probabilities to drop, so while attention dropout is
    active the module takes the plain path, as the JAX module does. While ``capture`` holds a list
    (``models/scot.py::forward_with_intermediates`` sets it for one call),
    the module takes the plain path and appends its post-softmax,
    post-dropout probabilities (N, heads, T, T) to it.
    """

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32,
                 impl: str = "xla", score_dtype: torch.dtype = torch.float32,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv_bias = qkv_bias
        self.dtype = dtype
        self.impl = impl
        self.score_dtype = score_dtype
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.self = _SelfAttention(dim, num_heads, window_size, qkv_bias)
        self.output = _SelfOutput(dim)
        self.capture: Optional[List[torch.Tensor]] = None

    def position_bias(self) -> torch.Tensor:
        """CPB MLP over the static log-coordinate table, gathered to
        (heads, T, T), then 16*sigmoid. fp32."""
        s = self.self
        table = s.continuous_position_bias_mlp(s.relative_coords_table)  # (M, H)
        t = self.window_size ** 2
        bias = table[s.relative_position_index.reshape(-1)].reshape(t, t, -1)
        return 16.0 * torch.sigmoid(bias.permute(2, 0, 1))

    def logit_scale(self) -> torch.Tensor:
        """(H,) fp32 exp(min(logit_scale, log 100))."""
        return torch.exp(torch.clamp(self.self.logit_scale, max=math.log(1.0 / 0.01))).reshape(-1)

    def uses_kernel(self) -> bool:
        """The kernel path, unless attention dropout is active or the
        probabilities are captured."""
        return (self.impl == "pallas" and self.capture is None
                and not (self.training and self.attn_drop > 0.0))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.uses_kernel():
            out = self._forward_kernel(x, mask)
        else:
            out = self._forward_plain(x, mask, generator)
        return dropout(out, self.proj_drop, self.training, generator)

    def _forward_kernel(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The kernel path: one fused QKV GEMM, the attention kernel reading
        q/k/v straight out of its (N, T, 3C) output, then the proj GEMM."""
        s, dt = self.self, self.dtype
        c = self.dim
        w_qkv = torch.cat([s.query.weight, s.key.weight, s.value.weight], dim=0)
        qkv = x.to(dt) @ w_qkv.to(dt).t()
        qb = s.query.bias.float() if self.qkv_bias else torch.zeros(c, device=x.device)
        bias = self.position_bias()
        # bm = CPB bias + the doubled shift mask, (nW, H, T, T); nW = 1 for
        # unshifted blocks.
        bm = bias[None] if mask is None else bias[None] + 2.0 * mask[:, None]
        out = window_attention(qkv, qb, bm.contiguous(), self.logit_scale(), self.num_heads)
        wp, proj_bias = self.output.dense.weight, self.output.dense.bias
        if self.qkv_bias:
            # Softmax rows sum to 1, so P @ (v + b) == P @ v + b: the v-bias
            # passes through to the output projection as bp + Wp @ bv. (A
            # 2-D product: a 1-D one squeezes the GEMM's output in place,
            # which selective checkpointing refuses for a saved output.)
            proj_bias = proj_bias + F.linear(s.value.bias[None], wp)[0]
        return out @ wp.to(dt).t() + proj_bias.to(dt)

    def _forward_plain(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        s, dt, sd = self.self, self.dtype, self.score_dtype
        bnw, t, c = x.shape
        heads, hd = self.num_heads, self.dim // self.num_heads
        w_qkv = torch.cat([s.query.weight, s.key.weight, s.value.weight], dim=0)
        qkv = x.to(dt) @ w_qkv.to(dt).t()
        q, k, v = qkv.split(c, dim=-1)
        if self.qkv_bias:
            q = q + s.query.bias.to(dt)
            v = v + s.value.bias.to(dt)
        q = q.reshape(bnw, t, heads, hd)
        k = k.reshape(bnw, t, heads, hd)
        v = v.reshape(bnw, t, heads, hd)
        # fp32 cosine attention; the logit scale is folded into q.
        qf = F.normalize(q.float(), dim=-1, eps=1e-12)
        kf = F.normalize(k.float(), dim=-1, eps=1e-12)
        qf = qf * self.logit_scale().reshape(1, 1, heads, 1)
        scores = torch.einsum("bthd,bshd->bhts", qf.to(sd), kf.to(sd))
        scores = scores + self.position_bias()[None].to(sd)
        if mask is not None:
            nw = mask.shape[0]
            scores = scores.reshape(bnw // nw, nw, heads, t, t) + 2.0 * mask.to(sd)[None, :, None]
            scores = scores.reshape(bnw, heads, t, t)
        probs = torch.softmax(scores, dim=-1)
        probs = dropout(probs, self.attn_drop, self.training, generator)
        if self.capture is not None:
            self.capture.append(probs)
        out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v).reshape(bnw, t, c)
        return out @ self.output.dense.weight.to(dt).t() + self.output.dense.bias.to(dt)
