"""The plain reference of scOT (Poseidon), written from the model's
description: patch embedding, shifted-window cosine attention with a
log-spaced continuous position bias, an MLP, lead-time-conditioned
LayerNorms after each (post-norm), patch merging and expanding, ConvNeXt
skip blocks, patch recovery, the pixel mask and the channel-grouped L1
loss. Functions over a dict of named float32 tensors, named as the
checkpoints name them, so one dict of weights loads into the system under
test and feeds this file.

Nothing here imports the system under test. Products go through a
precision object (``precision.py``): float32 for the reference, fp8 for the
control. Supported: conditioning on, ConvNeXt skips, no dropout or
drop-path, square inputs at the configured size.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import Exact

Params = Dict[str, torch.Tensor]


def stage_geometry(model: dict, i: int) -> Tuple[int, int, int, int]:
    """(resolution, width, heads, window) of stage ``i``."""
    res = model["image_size"] // model["patch_size"] // 2 ** i
    return res, model["embed_dim"] * 2 ** i, model["num_heads"][i], min(model["window_size"], res)


def _norm_shapes(prefix: str, dim: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.weight.weight", (dim, 1)), (f"{prefix}.weight.bias", (dim,)),
            (f"{prefix}.bias.weight", (dim, 1)), (f"{prefix}.bias.bias", (dim,))]


def _block_shapes(prefix: str, dim: int, heads: int, hidden: int) -> List[Tuple[str, tuple]]:
    a = f"{prefix}.attention"
    return ([(f"{a}.self.query.weight", (dim, dim)), (f"{a}.self.query.bias", (dim,)),
             (f"{a}.self.key.weight", (dim, dim)),
             (f"{a}.self.value.weight", (dim, dim)), (f"{a}.self.value.bias", (dim,)),
             (f"{a}.self.logit_scale", (heads, 1, 1)),
             (f"{a}.self.continuous_position_bias_mlp.0.weight", (512, 2)),
             (f"{a}.self.continuous_position_bias_mlp.0.bias", (512,)),
             (f"{a}.self.continuous_position_bias_mlp.2.weight", (heads, 512)),
             (f"{a}.output.dense.weight", (dim, dim)), (f"{a}.output.dense.bias", (dim,))]
            + _norm_shapes(f"{prefix}.layernorm_before", dim)
            + [(f"{prefix}.intermediate.dense.weight", (hidden, dim)),
               (f"{prefix}.intermediate.dense.bias", (hidden,)),
               (f"{prefix}.output.dense.weight", (dim, hidden)),
               (f"{prefix}.output.dense.bias", (dim,))]
            + _norm_shapes(f"{prefix}.layernorm_after", dim))


def param_shapes(model: dict) -> List[Tuple[str, tuple]]:
    """Every weight's name and shape, in a fixed order."""
    p, e = model["patch_size"], model["embed_dim"]
    cin, cout = model["num_channels"], model["num_out_channels"]
    n = len(model["depths"])
    out = [("embeddings.patch_embeddings.projection.weight", (e, cin, p, p)),
           ("embeddings.patch_embeddings.projection.bias", (e,))]
    out += _norm_shapes("embeddings.norm", e)
    for i in range(n):
        _, dim, heads, _ = stage_geometry(model, i)
        hidden = int(model["mlp_ratio"] * dim)
        for j in range(model["depths"][i]):
            out += _block_shapes(f"encoder.layers.{i}.blocks.{j}", dim, heads, hidden)
        if i < n - 1:
            out.append((f"encoder.layers.{i}.downsample.reduction.weight", (2 * dim, 4 * dim)))
            out += _norm_shapes(f"encoder.layers.{i}.downsample.norm", 2 * dim)
    for i, depth in enumerate(model["skip_connections"]):
        dim = e * 2 ** i
        for j in range(depth):
            r = f"residual_blocks.{i}.{j}"
            out += [(f"{r}.dwconv.weight", (dim, 1, 7, 7)), (f"{r}.dwconv.bias", (dim,))]
            out += _norm_shapes(f"{r}.norm", dim)
            out += [(f"{r}.pwconv1.weight", (4 * dim, dim)), (f"{r}.pwconv1.bias", (4 * dim,)),
                    (f"{r}.pwconv2.weight", (dim, 4 * dim)), (f"{r}.pwconv2.bias", (dim,)),
                    (f"{r}.weight", (dim,))]
    for k in range(n):
        lvl = n - 1 - k
        _, dim, heads, _ = stage_geometry(model, lvl)
        hidden = int(model["mlp_ratio"] * dim)
        for j in range(model["depths"][lvl]):
            out += _block_shapes(f"decoder.layers.{k}.blocks.{j}", dim, heads, hidden)
        if lvl > 0:
            u = f"decoder.layers.{k}.upsample"
            out += [(f"{u}.upsample.weight", (2 * dim, dim)),
                    (f"{u}.mixup.weight", (dim // 2, dim // 2))]
            out += _norm_shapes(f"{u}.norm", dim // 2)
    out += [("patch_recovery.projection.weight", (e, cout, p, p)),
            ("patch_recovery.projection.bias", (cout,)),
            ("patch_recovery.mixup.weight", (cout, cout, 5, 5))]
    return out


def is_norm_param(name: str) -> bool:
    parts = name.split(".")
    return any(part in ("norm", "layernorm_before", "layernorm_after") for part in parts[:-2])


# ---------------------------------------------------------------------------
# Window geometry
# ---------------------------------------------------------------------------

def coords_table(window: int) -> torch.Tensor:
    """((2w-1)^2, 2): relative offsets scaled to +-8, then
    sign * log2(1 + |x|) / log2(8)."""
    r = torch.arange(-(window - 1), window, dtype=torch.float64)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    t = torch.stack([dy, dx], -1)
    if window > 1:
        t = t / (window - 1)
    t = t * 8.0
    t = torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8.0)
    return t.reshape(-1, 2).float()


def offset_index(window: int) -> torch.Tensor:
    """(T, T): for query a and key b of a window, the row of the table that
    holds their offset (dy, dx)."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy = ys[:, None] - ys[None, :] + window - 1
    dx = xs[:, None] - xs[None, :] + window - 1
    return dy * (2 * window - 1) + dx


def shift_mask(res: int, window: int, shift: int) -> torch.Tensor:
    """(windows, T, T): -100 between tokens that the cyclic shift brought
    from different regions of the image, else 0."""
    region = torch.zeros(res, res)
    bounds = ((0, res - window), (res - window, res - shift), (res - shift, res))
    label = 0
    for y0, y1 in bounds:
        for x0, x1 in bounds:
            region[y0:y1, x0:x1] = label
            label += 1
    n = res // window
    region = region.reshape(n, window, n, window).permute(0, 2, 1, 3).reshape(n * n, -1)
    return torch.where(region[:, :, None] != region[:, None, :], -100.0, 0.0)


def to_windows(x: torch.Tensor, window: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def from_windows(x: torch.Tensor, window: int, res: int) -> torch.Tensor:
    n = res // window
    x = x.reshape(-1, n, n, window, window, x.shape[-1]).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, res, res, x.shape[-1])


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

class Reference:
    """scOT's forward and loss over ``params`` for the configuration's
    ``model`` section, with products at ``precision``."""

    def __init__(self, model: dict, precision=None):
        off = ("hidden_dropout_prob", "attention_probs_dropout_prob", "drop_path_rate",
               "learn_residual", "use_absolute_embeddings")
        if model.get("residual_model", "convnext") != "convnext" or \
                not model.get("use_conditioning", True) or any(model.get(k) for k in off):
            raise ValueError("the reference covers conditioned models with ConvNeXt skips, "
                             "no dropout, drop-path, residual learning or absolute embeddings")
        self.model = model
        self.prec = precision or Exact()
        self.eps = model.get("layer_norm_eps", 1e-5)
        self._geometry = {}

    def _geo(self, res: int, window: int, shift: int, device) -> tuple:
        key = (res, window, shift, str(device))
        if key not in self._geometry:
            mask = shift_mask(res, window, shift).to(device) if shift else None
            self._geometry[key] = (coords_table(window).to(device),
                                   offset_index(window).to(device), mask)
        return self._geometry[key]

    def norm(self, P: Params, prefix: str, x: torch.Tensor, t: torch.Tensor,
             eps: Optional[float] = None) -> torch.Tensor:
        """Conditional LayerNorm: the normalised row, scaled by
        W_s t + b_s and shifted by W_b t + b_b, per sample."""
        eps = self.eps if eps is None else eps
        xhat = F.layer_norm(x, x.shape[-1:], eps=eps)
        scale = t[:, None] * P[f"{prefix}.weight.weight"][:, 0] + P[f"{prefix}.weight.bias"]
        shift = t[:, None] * P[f"{prefix}.bias.weight"][:, 0] + P[f"{prefix}.bias.bias"]
        view = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        return xhat * scale.reshape(view) + shift.reshape(view)

    def attention(self, P: Params, prefix: str, x: torch.Tensor, heads: int, window: int,
                  res: int, shift: int) -> torch.Tensor:
        s = f"{prefix}.self"
        n, t, c = x.shape
        d = c // heads
        q = self.prec.linear(x, P[f"{s}.query.weight"], P[f"{s}.query.bias"])
        k = self.prec.linear(x, P[f"{s}.key.weight"])
        v = self.prec.linear(x, P[f"{s}.value.weight"], P[f"{s}.value.bias"])
        q, k, v = (y.reshape(n, t, heads, d).transpose(1, 2) for y in (q, k, v))
        q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
        table, index, mask = self._geo(res, window, shift, x.device)
        cpb = F.linear(F.relu(F.linear(table, P[f"{s}.continuous_position_bias_mlp.0.weight"],
                                       P[f"{s}.continuous_position_bias_mlp.0.bias"])),
                       P[f"{s}.continuous_position_bias_mlp.2.weight"])
        bias = 16.0 * torch.sigmoid(cpb[index].permute(2, 0, 1))           # (H, T, T)
        scale = torch.exp(torch.clamp(P[f"{s}.logit_scale"], max=math.log(100.0)))
        scores = self.prec.einsum("nhtd,nhsd->nhts", q, k) * scale + bias
        if mask is not None:
            w = mask.shape[0]
            # The checkpoints' attention adds the shift mask twice.
            scores = (scores.reshape(n // w, w, heads, t, t) + 2.0 * mask[None, :, None])
            scores = scores.reshape(n, heads, t, t)
        out = self.prec.einsum("nhts,nhsd->nhtd", torch.softmax(scores, -1), v)
        out = out.transpose(1, 2).reshape(n, t, c)
        return self.prec.linear(out, P[f"{prefix}.output.dense.weight"],
                                P[f"{prefix}.output.dense.bias"])

    def block(self, P: Params, prefix: str, x: torch.Tensor, t: torch.Tensor, stage: int,
              shifted: bool) -> torch.Tensor:
        res, dim, heads, window = stage_geometry(self.model, stage)
        shift = self.model["window_size"] // 2 if shifted and res > window else 0
        b = x.shape[0]
        h = x.reshape(b, res, res, dim)
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        h = self.attention(P, f"{prefix}.attention", to_windows(h, window), heads, window,
                           res, shift)
        h = from_windows(h, window, res)
        if shift:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + self.norm(P, f"{prefix}.layernorm_before", h.reshape(b, -1, dim), t)
        m = self.prec.linear(x, P[f"{prefix}.intermediate.dense.weight"],
                             P[f"{prefix}.intermediate.dense.bias"])
        m = self.prec.linear(F.gelu(m), P[f"{prefix}.output.dense.weight"],
                             P[f"{prefix}.output.dense.bias"])
        return x + self.norm(P, f"{prefix}.layernorm_after", m, t)

    def merge(self, P: Params, prefix: str, x: torch.Tensor, t: torch.Tensor, res: int):
        b, _, c = x.shape
        x = x.reshape(b, res, res, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1).reshape(b, -1, 4 * c)
        return self.norm(P, f"{prefix}.norm", self.prec.linear(x, P[f"{prefix}.reduction.weight"]),
                         t)

    def expand(self, P: Params, prefix: str, x: torch.Tensor, t: torch.Tensor, res: int):
        b, _, c = x.shape
        x = self.prec.linear(x, P[f"{prefix}.upsample.weight"])
        x = x.reshape(b, res, res, 2, 2, c // 2).permute(0, 1, 3, 2, 4, 5)
        x = self.norm(P, f"{prefix}.norm", x.reshape(b, 4 * res * res, c // 2), t)
        return self.prec.linear(x, P[f"{prefix}.mixup.weight"])

    def convnext(self, P: Params, prefix: str, x: torch.Tensor, t: torch.Tensor):
        b, l, c = x.shape
        side = math.isqrt(l)
        h = x.reshape(b, side, side, c).permute(0, 3, 1, 2)
        h = self.prec.conv2d(h, P[f"{prefix}.dwconv.weight"], P[f"{prefix}.dwconv.bias"],
                             padding=3, groups=c).permute(0, 2, 3, 1)
        h = self.norm(P, f"{prefix}.norm", h, t)
        h = F.gelu(self.prec.linear(h, P[f"{prefix}.pwconv1.weight"], P[f"{prefix}.pwconv1.bias"]))
        h = self.prec.linear(h, P[f"{prefix}.pwconv2.weight"], P[f"{prefix}.pwconv2.bias"])
        return x + (h * P[f"{prefix}.weight"]).reshape(b, l, c)

    def forward(self, P: Params, pixel_values: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        """(B, C_in, H, W), (B,) -> the prediction (B, C_out, H, W)."""
        m = self.model
        n = len(m["depths"])
        t = time.float()
        x = self.prec.conv2d(pixel_values.float(),
                             P["embeddings.patch_embeddings.projection.weight"],
                             P["embeddings.patch_embeddings.projection.bias"],
                             stride=m["patch_size"])
        b, e, g, _ = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, g * g, e)
        x = self.norm(P, "embeddings.norm", x, t, eps=1e-5)
        skips = []
        for i in range(n):
            entry = x
            for j in range(m["depths"][i]):
                x = self.block(P, f"encoder.layers.{i}.blocks.{j}", x, t, i, j % 2 == 1)
            skips.append(x)
            if i < n - 1:
                x = self.merge(P, f"encoder.layers.{i}.downsample", x + entry, t,
                               stage_geometry(m, i)[0])
        for i, depth in enumerate(m["skip_connections"]):
            for j in range(depth):
                skips[i] = self.convnext(P, f"residual_blocks.{i}.{j}", skips[i], t)
        x = skips[-1]
        for k in range(n):
            lvl = n - 1 - k
            if k > 0:
                x = x + skips[lvl]
            depth = m["depths"][lvl]
            for j in range(depth):
                # Decoder stages run their shifted blocks first.
                x = self.block(P, f"decoder.layers.{k}.blocks.{j}", x, t, lvl,
                               (depth - 1 - j) % 2 == 1)
            if lvl > 0:
                x = self.expand(P, f"decoder.layers.{k}.upsample", x, t,
                                stage_geometry(m, lvl)[0])
        x = x.reshape(b, g, g, e).permute(0, 3, 1, 2)
        p = m["patch_size"]
        y = self.prec.conv_transpose2d(x, P["patch_recovery.projection.weight"],
                                       P["patch_recovery.projection.bias"], stride=p)
        return self.prec.conv2d(y, P["patch_recovery.mixup.weight"], padding=2)

    def loss_terms(self, pred: torch.Tensor, labels: torch.Tensor,
                   pixel_mask: Optional[torch.Tensor]) -> List[torch.Tensor]:
        """Per channel group, the sum over these rows of |prediction -
        label| with masked channels taken from the labels. Divided by the
        group's element count and its label norm (:meth:`label_norms`) and
        averaged over groups, it is the loss; sums over row blocks add up."""
        if pixel_mask is not None:
            pred = torch.where(pixel_mask[:, :, None, None], labels, pred)
        bounds = self._groups()
        return [(pred[:, lo:hi] - labels[:, lo:hi]).abs().sum() for lo, hi in bounds]

    def label_norms(self, labels: torch.Tensor) -> List[torch.Tensor]:
        """Per channel group, mean |label| over the whole batch."""
        return [labels[:, lo:hi].abs().mean() for lo, hi in self._groups()]

    def _groups(self):
        if self.model.get("p", 1) != 1:
            raise ValueError("the reference's loss is the L1 loss")
        s = self.model.get("channel_slice_list_normalized_loss")
        if s is None:
            raise ValueError("the reference's loss is channel-grouped")
        return list(zip(s[:-1], s[1:]))

    def loss(self, sums: List[torch.Tensor], norms: List[torch.Tensor],
             rows: int, labels_shape) -> torch.Tensor:
        """The batch's loss from the summed :meth:`loss_terms` of its
        ``rows`` rows."""
        terms = []
        for (lo, hi), s, norm in zip(self._groups(), sums, norms):
            count = rows * (hi - lo) * int(np.prod(labels_shape[2:]))
            terms.append(s / count / (norm + 1e-10))
        return torch.stack(terms).mean()
