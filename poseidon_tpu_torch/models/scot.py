"""The scOT model in PyTorch: a SwinV2-style hierarchical vision-transformer
neural operator with a U-Net encoder/decoder, mirroring
``poseidon_tpu.models.scot``.

- SwinBlock: post-norm residuals, ``x = x + drop_path(norm(attn(x)))`` then
  ``x = x + drop_path(norm(mlp(x)))``, the second in one kernel under
  ``fused_block_tail`` (see ``SwinBlock.uses_fused_tail``).
- Encode stage: blocks alternating shift 0 / window//2, then PatchMerging
  applied to ``blocks_out + stage_input``. The deepest stage has no merging.
- Decode stage: deepest first, blocks shifted-first when the depth is even,
  PatchUnmerging between stages, skips added before stages 1..N-1.
- Drop-path rates: linspace(0, rate, 2*sum(depths)), first half encoder,
  second half decoder.
- FFT resampling when the input resolution differs from ``image_size``.
- ``remat`` (gradient checkpointing) per SwinBlock, the JAX package's four
  modes; see :func:`run_block`.
- :func:`forward_with_intermediates`: the prediction with every stage
  output and every block's attention probabilities.
- ``ScOT.forward`` replays a CUDA graph of the forward on the calls without
  autograd that allow it (``forward_graph.py``).

Module and parameter names follow the reference PyTorch state dict
(``embeddings``, ``encoder.layers.{i}``, ``decoder.layers.{k}`` in execution
order, ``residual_blocks.{i}.{j}``, ``patch_recovery``), so
``load_state_dict(hub.from_jax_params(...), strict=True)`` is the whole
weight bridge. Parameters stay fp32; ``dtype`` is the compute dtype.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint as tuc

from ..config import ScOTConfig
from ..ops.mlp import fused_mlp, mlp_cln, use_fused_tail
from ..tracing import count_forward, span
from ..utils.device import resolve_device
from . import forward_graph
from .attention import (
    WindowAttention,
    shifted_window_mask,
    window_partition,
    window_reverse,
)
from .layers import (
    BatchNorm,
    ConvNeXtBlock,
    DropPath,
    PatchEmbed,
    PatchMerging,
    PatchRecovery,
    PatchUnmerging,
    PlainLayerNorm,
    ResNetBlock,
    dense,
    dropout,
    gelu_exact,
    make_norm,
)

# ---------------------------------------------------------------------------
# Spectral resampling
# ---------------------------------------------------------------------------


def fft_downsample(x: torch.Tensor, target_size: int) -> torch.Tensor:
    """Spectral downsample of (..., H, W) square images (norm='forward')."""
    n = x.shape[-2]
    freqs = np.fft.fftfreq(n, d=1.0 / n)
    sel = np.where((freqs >= -target_size / 2) & (freqs <= target_size / 2 - 1))[0]
    sel = torch.as_tensor(sel, device=x.device)
    xh = torch.fft.fft2(x, norm="forward")
    xh = xh.index_select(-2, sel).index_select(-1, sel)
    return torch.fft.ifft2(xh, norm="forward").real


def fft_upsample(x: torch.Tensor, target_size: int) -> torch.Tensor:
    """Spectral upsample of (..., H, W) square images by zero-padding the
    shifted spectrum (norm='forward')."""
    n = x.shape[-2]
    pad = (target_size - n) // 2
    xh = torch.fft.fftshift(torch.fft.fft2(x, norm="forward"), dim=(-2, -1))
    pads = (pad, pad, pad, pad)
    xh = torch.complex(nn.functional.pad(xh.real, pads), nn.functional.pad(xh.imag, pads))
    xh = torch.fft.ifftshift(xh, dim=(-2, -1))
    return torch.fft.ifft2(xh, norm="forward").real


# ---------------------------------------------------------------------------
# Transformer block
# ---------------------------------------------------------------------------

class _Dense(nn.Module):
    """Holds one Linear as ``dense`` (the reference's intermediate/output)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class SwinBlock(nn.Module):
    """One post-norm Swin transformer block on a (B, L, C) token map."""

    def __init__(self, config: ScOTConfig, dim: int, num_heads: int,
                 resolution: int, shifted: bool, drop_path: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.resolution = resolution
        self.dtype = dtype
        self.window = min(cfg.window_size, resolution)
        self.shift = (cfg.window_size // 2) if (shifted and resolution > self.window) else 0
        self.pad = -resolution % self.window
        side = resolution + self.pad
        mask = shifted_window_mask(side, side, self.window, self.shift)
        self.register_buffer("attn_mask", None if mask is None else torch.from_numpy(mask),
                             persistent=False)
        self.attention = WindowAttention(
            dim, num_heads, self.window, qkv_bias=cfg.qkv_bias, dtype=dtype,
            impl=cfg.attention_impl,
            score_dtype=torch.bfloat16 if cfg.score_dtype == "bfloat16" else torch.float32,
            attn_drop=cfg.attention_probs_dropout_prob,
            proj_drop=cfg.attention_probs_dropout_prob)
        self.layernorm_before = make_norm(cfg.use_conditioning, dim, cfg.layer_norm_eps, dtype,
                                          cfg.attention_impl)
        f = int(cfg.mlp_ratio * dim)
        self.intermediate = _Dense(dim, f)
        self.output = _Dense(f, dim)
        self.layernorm_after = make_norm(cfg.use_conditioning, dim, cfg.layer_norm_eps, dtype,
                                         cfg.attention_impl)
        self.drop_path = DropPath(drop_path)

    def kernels_on(self) -> bool:
        """The kernel path: under "pallas", unless the block's attention
        probabilities are being captured (only the plain path forms them)."""
        return self.config.attention_impl == "pallas" and self.attention.capture is None

    def uses_fused_tail(self, time: Optional[torch.Tensor], tokens: int) -> bool:
        """The fused block tail (``ops/mlp.py::mlp_cln``) in place of MLP ->
        dropout -> conditional norm -> drop-path -> residual: under the
        kernel path with ``fused_block_tail``, conditioning and a lead time,
        no active hidden dropout, and where ``use_fused_tail`` takes the
        stage (the JAX package's rule, ``models/scot.py:204-209``, with the
        port's gate in place of its TPU VMEM budget: the MLP kernel's
        stages with whole 64-row tiles an image, in bf16 and fp32, on the
        tail's Hopper kernels or its general ones)."""
        cfg = self.config
        fc = self.intermediate.dense
        return (self.kernels_on() and cfg.fused_block_tail
                and cfg.use_conditioning and time is not None
                and (cfg.hidden_dropout_prob == 0.0 or not self.training)
                and use_fused_tail(fc.in_features, tokens, fc.out_features))

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg, dt = self.config, self.dtype
        b, l, c = x.shape
        h = w = self.resolution
        win, shift, pad = self.window, self.shift, self.pad

        shortcut = x
        with span("block.attention"):
            hs = x.reshape(b, h, w, c)
            if pad:
                hs = nn.functional.pad(hs, (0, 0, 0, pad, 0, pad))
            if shift:
                hs = torch.roll(hs, (-shift, -shift), dims=(1, 2))
            attn = self.attention(window_partition(hs, win), self.attn_mask, generator)
            hs = window_reverse(attn, win, h + pad, w + pad)
            if shift:
                hs = torch.roll(hs, (shift, shift), dims=(1, 2))
            if pad:
                hs = hs[:, :h, :w]
        with span("block.norm"):
            hs = self.layernorm_before(hs.reshape(b, l, c), time)
        x = shortcut + self.drop_path(hs, generator)

        w1, b1 = self.intermediate.dense.weight, self.intermediate.dense.bias
        w2, b2 = self.output.dense.weight, self.output.dense.bias
        if self.uses_fused_tail(time, l):
            # MLP + conditional LayerNorm + residual in one kernel; the
            # drop-path keep mask folds into the per-sample scale and shift
            # (the tail is linear in them), drawn as the unfused branch's
            # second DropPath draws it.
            with span("block.mlp"):
                norm = self.layernorm_after
                t = time.reshape(-1, 1).float()
                scale = F.linear(t, norm.weight.weight, norm.weight.bias)
                shift = F.linear(t, norm.bias.weight, norm.bias.bias)
                factor = self.drop_path.keep_factor(b, generator)
                if factor is not None:
                    factor = factor.to(x.device)[:, None]
                    scale, shift = scale * factor, shift * factor
                return mlp_cln(x.to(dt), w1.to(dt), b1, w2.to(dt), b2, scale, shift, norm.eps)
        with span("block.mlp"):
            if self.kernels_on():
                mlp = fused_mlp(x.to(dt), w1.to(dt), b1, w2.to(dt), b2)
            else:
                mlp = dense(gelu_exact(dense(x.to(dt), w1, b1)), w2, b2)
            mlp = dropout(mlp, cfg.hidden_dropout_prob, self.training, generator)
        with span("block.norm"):
            mlp = self.layernorm_after(mlp, time)
        return x + self.drop_path(mlp, generator)


# ---------------------------------------------------------------------------
# Gradient checkpointing
# ---------------------------------------------------------------------------

REMAT_MODES = (False, True, "save_all", "save_dots")


def _check_remat(mode) -> None:
    if mode not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {mode!r}")


# The matrix products whose outputs "save_dots" keeps (JAX's dots_saveable).
_DOT_OPS = frozenset(
    op for op in (getattr(torch.ops.aten, name, None)
                  for name in ("mm", "bmm", "addmm", "baddbmm", "addbmm", "_scaled_mm"))
    if op is not None)


def _save_dots_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (tuc.CheckpointPolicy.MUST_SAVE if op.overloadpacket in _DOT_OPS
            else tuc.CheckpointPolicy.PREFER_RECOMPUTE)


def _draws_masks(block: SwinBlock) -> bool:
    cfg = block.config
    return block.training and (cfg.hidden_dropout_prob > 0.0
                               or cfg.attention_probs_dropout_prob > 0.0
                               or block.drop_path.rate > 0.0)


def run_block(block: SwinBlock, x: torch.Tensor, time: Optional[torch.Tensor],
              generator: Optional[torch.Generator], remat: Union[bool, str]) -> torch.Tensor:
    """``block(x, time, generator)`` under the ``remat`` mode of the JAX
    field (``poseidon_tpu/models/scot.py::_remat_block``):

    - ``False`` and ``"save_all"``: the block as it is (PyTorch's autograd
      graph already keeps every residual per op: saving all of them is the
      plain call);
    - ``True``: ``torch.utils.checkpoint`` (non-reentrant), the block's
      forward run again in the backward;
    - ``"save_dots"``: selective checkpointing that keeps the outputs of
      the matrix products and recomputes the rest.

    The recompute draws the forward's dropout and drop-path masks: the
    generator's state at block entry is set again for it, and the state the
    generator had before the recompute is put back after it (also when the
    recompute stops early), so the generator ends where the plain step
    leaves it. A block that draws no mask saves and restores nothing.
    Without grad, or while intermediates are captured, the block runs as
    it is."""
    if (remat in (False, "save_all") or not torch.is_grad_enabled()
            or block.attention.capture is not None):
        return block(x, time, generator)
    draws = _draws_masks(block)
    if draws and generator is not None:
        entry_state = generator.get_state()
        calls = [0]

        def fn(x, time):
            calls[0] += 1
            if calls[0] == 1:  # the forward
                return block(x, time, generator)
            after = generator.get_state()
            generator.set_state(entry_state)
            try:
                return block(x, time, generator)
            finally:
                generator.set_state(after)
    else:
        def fn(x, time):
            return block(x, time, generator)

    kw = {}
    if remat == "save_dots":
        kw["context_fn"] = functools.partial(tuc.create_selective_checkpoint_contexts,
                                             _save_dots_policy)
    # Masks drawn from the global RNG (no generator) need its state kept.
    return tuc.checkpoint(fn, x, time, use_reentrant=False,
                          preserve_rng_state=draws and generator is None, **kw)


# ---------------------------------------------------------------------------
# Encoder / decoder
# ---------------------------------------------------------------------------

def _drop_path_rates(cfg: ScOTConfig) -> Tuple[List[float], List[float]]:
    total = 2 * sum(cfg.depths)
    rates = [float(r) for r in np.linspace(0.0, cfg.drop_path_rate, total)]
    half = total // 2
    return rates[:half], rates[half:]


class _Stage(nn.Module):
    """One encoder or decoder stage: ``blocks`` plus its resampling module
    (``downsample`` / ``upsample``, or none)."""

    def __init__(self, blocks: List[SwinBlock], **resample: nn.Module):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        for name, mod in resample.items():
            setattr(self, name, mod)


class Encoder(nn.Module):
    """Hierarchical encoder; returns the pre-downsample state of every stage
    (the U-Net skip states). ``remat``: see :func:`run_block`."""

    def __init__(self, config: ScOTConfig, dtype: torch.dtype = torch.float32,
                 remat: Union[bool, str] = False):
        super().__init__()
        cfg = config
        self.remat = remat
        # A list while forward_with_intermediates captures the stage outputs.
        self.capture: Optional[List[torch.Tensor]] = None
        dpr, _ = _drop_path_rates(cfg)
        layers = []
        for i in range(cfg.num_stages):
            res, dim, depth = cfg.stage_resolution(i), cfg.stage_dim(i), cfg.depths[i]
            off = sum(cfg.depths[:i])
            blocks = [SwinBlock(cfg, dim, cfg.num_heads[i], res, shifted=(j % 2 == 1),
                                drop_path=dpr[off + j], dtype=dtype)
                      for j in range(depth)]
            resample = {}
            if i < cfg.num_stages - 1:
                resample["downsample"] = PatchMerging(
                    dim, res, cfg.use_conditioning, cfg.layer_norm_eps, dtype, cfg.attention_impl)
            layers.append(_Stage(blocks, **resample))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        skips = []
        for stage in self.layers:
            stage_input = x
            for blk in stage.blocks:
                x = run_block(blk, x, time, generator, self.remat)
            skips.append(x)
            if self.capture is not None:
                self.capture.append(x)
            if hasattr(stage, "downsample"):
                # The stage residual feeds the downsample.
                x = stage.downsample(x + stage_input, time)
        return skips


class Decoder(nn.Module):
    """Mirror decoder. ``layers[k]`` is pyramid level ``num_stages-1-k``
    (execution order, deepest first). ``remat``: see :func:`run_block`."""

    def __init__(self, config: ScOTConfig, dtype: torch.dtype = torch.float32,
                 remat: Union[bool, str] = False):
        super().__init__()
        cfg = config
        self.remat = remat
        self.capture: Optional[List[torch.Tensor]] = None
        _, dpr = _drop_path_rates(cfg)
        n = cfg.num_stages
        layers = []
        for k in range(n):
            lvl = n - 1 - k
            res, dim, depth = cfg.stage_resolution(lvl), cfg.stage_dim(lvl), cfg.depths[lvl]
            lo = sum(cfg.depths[lvl + 1:])
            # The j-th executed block is shifted iff (depth-1-j) is odd.
            blocks = [SwinBlock(cfg, dim, cfg.num_heads[lvl], res,
                                shifted=((depth - 1 - j) % 2 == 1),
                                drop_path=dpr[lo + j], dtype=dtype)
                      for j in range(depth)]
            resample = {}
            if lvl > 0:
                resample["upsample"] = PatchUnmerging(
                    dim, res, cfg.use_conditioning, cfg.layer_norm_eps, dtype, cfg.attention_impl)
            layers.append(_Stage(blocks, **resample))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, skips: List[torch.Tensor],
                time: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = len(self.layers)
        for k, stage in enumerate(self.layers):
            if k > 0:
                x = x + skips[n - 1 - k]
            for blk in stage.blocks:
                x = run_block(blk, x, time, generator, self.remat)
            if self.capture is not None:
                self.capture.append(x)
            if hasattr(stage, "upsample"):
                x = stage.upsample(x, time)
        return x


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class _Embeddings(nn.Module):
    def __init__(self, cfg: ScOTConfig, dtype: torch.dtype, use_mask_token: bool):
        super().__init__()
        self.patch_embeddings = PatchEmbed(cfg.patch_size, cfg.num_channels,
                                           cfg.embed_dim, dtype)
        # The embedding norm's eps is 1e-5 whatever layer_norm_eps says.
        self.norm = make_norm(cfg.use_conditioning, cfg.embed_dim, 1e-5, dtype, cfg.attention_impl)
        if use_mask_token:
            self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        if cfg.use_absolute_embeddings:
            self.position_embeddings = nn.Parameter(
                torch.zeros(1, cfg.grid_size * cfg.grid_size, cfg.embed_dim))


class ScOT(nn.Module):
    """U-Net-shaped scOT operator.

    ``model(pixel_values, time)`` with ``pixel_values`` NCHW (B, C_in, H, W)
    and ``time`` (B,) returns the fp32 NCHW prediction (B, C_out, H, W).
    Inside, everything is NHWC / (B, L, C), computed in ``dtype``.
    ``remat`` checkpoints every SwinBlock (:func:`run_block`); it changes
    memory and time, never the result.
    """

    def __init__(self, config: ScOTConfig, dtype: torch.dtype = torch.float32,
                 use_mask_token: bool = False, remat: Union[bool, str] = False):
        super().__init__()
        _check_remat(remat)
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.embeddings = _Embeddings(cfg, dtype, use_mask_token)
        self.encoder = Encoder(cfg, dtype, remat)
        blocks = []
        for i, depth in enumerate(cfg.skip_connections):
            dim = cfg.stage_dim(i)
            if cfg.residual_model == "convnext":
                stage = [ConvNeXtBlock(dim, cfg.use_conditioning, cfg.layer_norm_eps,
                                       dtype=dtype, impl=cfg.attention_impl)
                         for _ in range(depth)]
            else:
                stage = [ResNetBlock(dim, dtype) for _ in range(depth)]
            blocks.append(nn.ModuleList(stage))
        self.residual_blocks = nn.ModuleList(blocks)
        self.decoder = Decoder(cfg, dtype, remat)
        self.patch_recovery = PatchRecovery(cfg.patch_size, cfg.embed_dim,
                                            cfg.num_out_channels, cfg.grid_size, dtype)

    def train(self, mode: bool = True) -> "ScOT":
        """``nn.Module.train``; a change of mode also releases the forward's
        CUDA graph, whose key holds the mode, so that training after an
        evaluation does not keep the graph's pool."""
        if mode != self.training:
            forward_graph.release(self)
        return super().train(mode)

    def forward(self, pixel_values: torch.Tensor, time: Optional[torch.Tensor] = None,
                bool_masked_pos: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """On CUDA, a call without autograd that draws no masks replays a
        CUDA graph of :meth:`eager_forward` (``forward_graph.py``: the first
        call with a new input layout, model state or mode runs eagerly, the
        second in a row captures, later ones replay); every other call runs
        :meth:`eager_forward`. ``tracing.forward_graph_counts()`` counts
        both."""
        reason = forward_graph.eager_reason(self, pixel_values, time, bool_masked_pos)
        if reason is None:
            return forward_graph.graphed_forward(self, pixel_values, time, self.eager_forward)
        count_forward("eager." + reason)
        return self.eager_forward(pixel_values, time, bool_masked_pos, generator)

    def eager_forward(self, pixel_values: torch.Tensor, time: Optional[torch.Tensor] = None,
                      bool_masked_pos: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The forward's body, op by op: what a captured forward replays."""
        cfg, dt = self.config, self.dtype
        b = pixel_values.shape[0]
        if time is None:
            time = torch.zeros((b,), dtype=torch.float32, device=pixel_values.device)

        in_size = pixel_values.shape[-2]
        x = pixel_values
        if in_size != cfg.image_size:
            x = (fft_upsample if in_size < cfg.image_size else fft_downsample)(x, cfg.image_size)
        x = x.permute(0, 2, 3, 1).to(dt)  # NCHW -> NHWC

        emb = self.embeddings
        tokens = emb.norm(emb.patch_embeddings(x), time)
        if hasattr(emb, "mask_token") and bool_masked_pos is not None:
            m = bool_masked_pos[..., None].to(tokens.dtype)
            tokens = tokens * (1.0 - m) + emb.mask_token.to(tokens.dtype) * m
        if cfg.use_absolute_embeddings:
            tokens = tokens + emb.position_embeddings.to(tokens.dtype)
        tokens = dropout(tokens, cfg.hidden_dropout_prob, self.training, generator)

        skips = self.encoder(tokens, time, generator)
        processed = []
        for skip, stage in zip(skips, self.residual_blocks):
            h = skip
            for blk in stage:
                h = blk(h, time, generator)
            processed.append(h)
        decoded = self.decoder(processed[-1], processed[:-1], time, generator)
        pred = self.patch_recovery(decoded).permute(0, 3, 1, 2).float()  # NHWC -> NCHW

        if cfg.learn_residual:
            res_in = pixel_values[:, : cfg.num_out_channels]
            if in_size != cfg.image_size:
                res_in = (fft_upsample if in_size < cfg.image_size
                          else fft_downsample)(res_in, cfg.image_size)
            pred = pred + res_in
        if in_size != cfg.image_size:
            pred = (fft_upsample if in_size > cfg.image_size else fft_downsample)(pred, in_size)
        return pred

    @property
    def remat(self) -> Union[bool, str]:
        return self.encoder.remat

    @remat.setter
    def remat(self, mode: Union[bool, str]) -> None:
        _check_remat(mode)
        self.encoder.remat = self.decoder.remat = mode


def forward_with_intermediates(model: ScOT, pixel_values: torch.Tensor,
                               time: Optional[torch.Tensor] = None, **kwargs):
    """The reference's ``output_hidden_states`` / ``output_attentions``
    surface, as ``poseidon_tpu.models.scot.forward_with_intermediates``.
    Returns ``(prediction, hidden_states, attentions)``: the encoder stages'
    pre-downsample token maps in ascending order, then the decoder stage
    outputs deepest-first; and the post-softmax, post-dropout attention
    probabilities (N*nW, heads, T, T) of every block in execution order.
    ``kwargs`` go to ``model.forward`` (``bool_masked_pos``, ``generator``).

    Every block takes the plain path whatever ``attention_impl`` says (the
    kernels never form the probabilities), as the JAX function retraces
    with ``attention_impl="xla"``: the modules' ``capture`` lists are set
    for this call and cleared after it, and the model and its config are
    left as they were. Gradients flow as through ``model(...)``."""
    hidden_states: List[torch.Tensor] = []
    attentions: List[torch.Tensor] = []
    capturing = [(m, attentions) for m in model.modules() if isinstance(m, WindowAttention)]
    capturing += [(model.encoder, hidden_states), (model.decoder, hidden_states)]
    try:
        for module, sink in capturing:
            module.capture = sink
        pred = model(pixel_values, time, **kwargs)
    finally:
        for module, _ in capturing:
            module.capture = None
    return pred, hidden_states, attentions


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_weights(model: ScOT, generator: torch.Generator) -> None:
    """Random init from ``generator`` with the JAX package's initialisers:
    normal(initializer_range) for every projection, conv and CPB weight;
    zero biases, mask token and absolute embeddings; unit norm scales;
    logit scale log(10); ConvNeXt layer scale 1e-6; BatchNorm running stats
    (0, 1). Drawn on the CPU, so a seed gives the same weights on any
    device."""
    std = model.config.initializer_range

    def normal_(p: torch.Tensor) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            normal_(mod.weight)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (PlainLayerNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, WindowAttention):
            mod.self.logit_scale.fill_(math.log(10.0))
        elif isinstance(mod, ConvNeXtBlock):
            mod.weight.fill_(1e-6)
    normal_(model.patch_recovery.projection.weight)
    model.patch_recovery.projection.bias.zero_()
    for name in ("mask_token", "position_embeddings"):
        if hasattr(model.embeddings, name):
            getattr(model.embeddings, name).zero_()


def build_model(config: ScOTConfig, *, device=None, dtype: torch.dtype = torch.float32,
                seed: int = 0, remat: Union[bool, str] = False) -> ScOT:
    """A randomly initialised ScOT (weights from ``torch.Generator`` seeded
    with ``seed``) on ``device`` (default CUDA; raises when CUDA is absent
    and the caller did not ask for the CPU), in eval mode."""
    dev = resolve_device(device)
    model = ScOT(config, dtype=dtype, remat=remat)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


# ---------------------------------------------------------------------------
# Loss / mask utilities
# ---------------------------------------------------------------------------

def apply_pixel_mask(prediction: torch.Tensor, labels: torch.Tensor,
                     pixel_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Overwrite masked entries of the prediction with the labels. The mask
    is per-channel (B, C) or per-pixel (B, C, H, W)."""
    if pixel_mask is None:
        return prediction
    mask = pixel_mask
    if mask.ndim == 2:
        mask = mask[:, :, None, None]
    return torch.where(mask.bool(), labels.to(prediction.dtype), prediction)


def scot_loss(prediction: torch.Tensor, labels: torch.Tensor, config: ScOTConfig,
              sample_weights: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """L1/L2 loss, optionally per-channel-group normalised: mean over groups
    of ``loss(pred_g, label_g) / (loss(label_g, 0) + 1e-10)``.
    ``sample_weights`` (B,) masks samples out of every mean.

    ``group``: the process group over which the batch is split (the data
    axis), when it has more than one process. The loss is then this
    process's share of the loss of the whole batch, as the JAX package
    computes it over the global batch: the normalisers ``loss(label_g, 0)``
    and the sample count are summed over the group (labels and weights
    only, no gradient), and each process divides its own sum of errors by
    the global count. The shares of the group's processes sum to the loss
    of the whole batch, and so do their gradients: the caller makes the
    gradient reduction a sum (``train_step``)."""
    if group is not None and dist.get_world_size(group) > 1:
        return _loss_share(prediction, labels, config, sample_weights, group)
    if sample_weights is None:
        _mean = torch.mean
    else:
        w = sample_weights.float()

        def _mean(x):
            wb = w.reshape((-1,) + (1,) * (x.ndim - 1))
            denom = w.sum() * float(np.prod(x.shape[1:]))
            return (x.float() * wb).sum() / torch.clamp(denom, min=1e-10)

    if config.p == 1:
        def loss_fn(a, b):
            return _mean(torch.abs(a - b))
    else:
        def loss_fn(a, b):
            return _mean((a - b) ** 2)
    slices = config.channel_slice_list_normalized_loss
    if slices is None:
        return loss_fn(prediction, labels)
    terms = []
    for i in range(len(slices) - 1):
        p_g = prediction[:, slices[i]:slices[i + 1]]
        l_g = labels[:, slices[i]:slices[i + 1]]
        terms.append(loss_fn(p_g, l_g) / (loss_fn(l_g, torch.zeros_like(l_g)) + 1e-10))
    return torch.stack(terms).mean()


def forward_with_loss(model: nn.Module, pixel_values: torch.Tensor,
                      time: Optional[torch.Tensor], labels: torch.Tensor,
                      pixel_mask: Optional[torch.Tensor] = None, *,
                      generator: Optional[torch.Generator] = None,
                      group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass, masked prediction and loss, as
    ``poseidon_tpu.models.scot.forward_with_loss`` (the reference
    ``ScOT.forward`` with labels given): returns ``(loss, prediction)``.

    ``model`` is a :class:`ScOT` or a wrapper of one that holds it as
    ``module`` (DDP). Dropout, drop-path and BatchNorm follow the module's
    train/eval mode, the port's form of the JAX ``deterministic`` and
    ``mutable`` arguments: in train mode the masks come from ``generator``
    and the BatchNorm running statistics update in place. ``group``: see
    :func:`scot_loss`."""
    pred = model(pixel_values, time, generator=generator)
    pred = apply_pixel_mask(pred, labels, pixel_mask)
    config = getattr(model, "module", model).config
    return scot_loss(pred, labels, config, group=group), pred


def _loss_share(prediction: torch.Tensor, labels: torch.Tensor, config: ScOTConfig,
                sample_weights: Optional[torch.Tensor], group) -> torch.Tensor:
    """This process's share of :func:`scot_loss` over the batch split across
    ``group``."""
    b = prediction.shape[0]
    w = (torch.ones(b, device=prediction.device) if sample_weights is None
         else sample_weights.float())

    def total(x):  # the weighted sum, fp32
        return (x.float() * w.reshape((-1,) + (1,) * (x.ndim - 1))).sum()

    def err(a, c):
        return torch.abs(a - c) if config.p == 1 else (a - c) ** 2

    slices = config.channel_slice_list_normalized_loss
    bounds = [(None, None)] if slices is None else list(zip(slices[:-1], slices[1:]))
    labs = [labels[:, lo:hi] for lo, hi in bounds]
    with torch.no_grad():
        sums = torch.stack([w.sum()] + [total(err(l_g, torch.zeros_like(l_g))) for l_g in labs])
        dist.all_reduce(sums, group=group)
    terms = []
    for (lo, hi), l_g, norm in zip(bounds, labs, sums[1:]):
        count = torch.clamp(sums[0] * float(np.prod(l_g.shape[1:])), min=1e-10)
        num = total(err(prediction[:, lo:hi], l_g)) / count
        terms.append(num if slices is None else num / (norm / count + 1e-10))
    return torch.stack(terms).mean()
