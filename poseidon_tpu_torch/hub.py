"""Weight bridge between the JAX package's Flax params and this port.

The port's parameter names are those of the reference PyTorch state dict,
so a Flax params tree goes through :func:`from_jax_params` (the layout
logic of ``poseidon_tpu.hub.export_torch_state_dict`` and
``unroll_scanned_params``, in numpy) and then
``model.load_state_dict(sd, strict=True)``. :func:`from_pretrained` loads a
reference-format checkpoint directory (``config.json`` plus
``model.safetensors`` or ``pytorch_model.bin``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .config import ScOTConfig
from .models.scot import ScOT
from .utils.device import resolve_device

# ---------------------------------------------------------------------------
# Flax -> reference layout
# ---------------------------------------------------------------------------


def _linear_w(w) -> np.ndarray:
    # Dense kernel (in, out) -> Linear weight (out, in)
    return np.ascontiguousarray(np.asarray(w).T)


def _conv_w(w) -> np.ndarray:
    # (kh, kw, I, O) -> (O, I, kh, kw)
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _patch_embed_w(w, p: int) -> np.ndarray:
    # (p*p*C, E) in (dy, dx, c) row order -> Conv2d (E, C, p, p)
    w = np.asarray(w)
    return np.ascontiguousarray(w.reshape(p, p, -1, w.shape[-1]).transpose(3, 2, 0, 1))


def _patch_recovery_w(w, p: int) -> np.ndarray:
    # (E, p*p*O) in (dy, dx, o) column order -> ConvTranspose2d (E, O, p, p)
    w = np.asarray(w)
    return np.ascontiguousarray(w.reshape(w.shape[0], p, p, -1).transpose(0, 3, 1, 2))


def _stage_block(node: Mapping, i: int, j: int) -> Mapping:
    """Block j of stage i from either the unrolled (stage_i_block_j) or the
    scanned (stage_i_pairs, leading pair axis) layout."""
    pairs = node.get(f"stage_{i}_pairs")
    if pairs is None:
        return node[f"stage_{i}_block_{j}"]

    def take(sub):
        if isinstance(sub, Mapping):
            return {k: take(v) for k, v in sub.items()}
        return np.asarray(sub)[j // 2]

    return take(pairs["block_a" if j % 2 == 0 else "block_b"])


def from_jax_params(params: Mapping, cfg: ScOTConfig,
                    batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The port's state dict (fp32 CPU tensors) for a Flax ScOT params tree
    (nested dicts of arrays; unrolled or ``scan_blocks`` layout) and, for
    the resnet skip blocks, its ``batch_stats``."""
    out: Dict[str, np.ndarray] = {}

    def put_norm(prefix: str, node: Mapping):
        if cfg.use_conditioning:
            out[f"{prefix}.weight.weight"] = _linear_w(node["cond_scale"]["kernel"])
            out[f"{prefix}.weight.bias"] = np.asarray(node["cond_scale"]["bias"])
            out[f"{prefix}.bias.weight"] = _linear_w(node["cond_shift"]["kernel"])
            out[f"{prefix}.bias.bias"] = np.asarray(node["cond_shift"]["bias"])
        else:
            out[f"{prefix}.weight"] = np.asarray(node["LayerNorm_0"]["scale"])
            out[f"{prefix}.bias"] = np.asarray(node["LayerNorm_0"]["bias"])

    def put_block(prefix: str, node: Mapping):
        attn = node["attn"]
        sa = f"{prefix}.attention.self"
        out[f"{sa}.query.weight"] = _linear_w(attn["query"]["kernel"])
        out[f"{sa}.key.weight"] = _linear_w(attn["key"]["kernel"])
        out[f"{sa}.value.weight"] = _linear_w(attn["value"]["kernel"])
        if cfg.qkv_bias:
            out[f"{sa}.query.bias"] = np.asarray(attn["query"]["bias"])
            out[f"{sa}.value.bias"] = np.asarray(attn["value"]["bias"])
        out[f"{sa}.logit_scale"] = np.asarray(attn["logit_scale"])
        out[f"{sa}.continuous_position_bias_mlp.0.weight"] = _linear_w(attn["cpb_mlp1"]["kernel"])
        out[f"{sa}.continuous_position_bias_mlp.0.bias"] = np.asarray(attn["cpb_mlp1"]["bias"])
        out[f"{sa}.continuous_position_bias_mlp.2.weight"] = _linear_w(attn["cpb_mlp2"]["kernel"])
        out[f"{prefix}.attention.output.dense.weight"] = _linear_w(attn["proj"]["kernel"])
        out[f"{prefix}.attention.output.dense.bias"] = np.asarray(attn["proj"]["bias"])
        out[f"{prefix}.intermediate.dense.weight"] = _linear_w(node["mlp_fc1"]["kernel"])
        out[f"{prefix}.intermediate.dense.bias"] = np.asarray(node["mlp_fc1"]["bias"])
        out[f"{prefix}.output.dense.weight"] = _linear_w(node["mlp_fc2"]["kernel"])
        out[f"{prefix}.output.dense.bias"] = np.asarray(node["mlp_fc2"]["bias"])
        put_norm(f"{prefix}.layernorm_before", node["norm_attn"])
        put_norm(f"{prefix}.layernorm_after", node["norm_mlp"])

    emb = params["embeddings"]["projection"]
    out["embeddings.patch_embeddings.projection.weight"] = _patch_embed_w(emb["kernel"], cfg.patch_size)
    out["embeddings.patch_embeddings.projection.bias"] = np.asarray(emb["bias"])
    put_norm("embeddings.norm", params["embed_norm"])
    for name in ("mask_token", "position_embeddings"):
        if name in params:
            out[f"embeddings.{name}"] = np.asarray(params[name])

    enc, dec = params["encoder"], params["decoder"]
    for i in range(cfg.num_stages):
        for j in range(cfg.depths[i]):
            put_block(f"encoder.layers.{i}.blocks.{j}", _stage_block(enc, i, j))
        if i < cfg.num_stages - 1:
            ds = enc[f"downsample_{i}"]
            out[f"encoder.layers.{i}.downsample.reduction.weight"] = _linear_w(ds["reduction"]["kernel"])
            put_norm(f"encoder.layers.{i}.downsample.norm", ds["norm"])

    # Decoder layer k is pyramid level num_stages-1-k.
    for k in range(cfg.num_stages):
        lvl = cfg.num_stages - 1 - k
        for j in range(cfg.depths[lvl]):
            put_block(f"decoder.layers.{k}.blocks.{j}", _stage_block(dec, lvl, j))
        if lvl > 0:
            us = dec[f"upsample_{lvl}"]
            out[f"decoder.layers.{k}.upsample.upsample.weight"] = _linear_w(us["expand"]["kernel"])
            out[f"decoder.layers.{k}.upsample.mixup.weight"] = _linear_w(us["mixup"]["kernel"])
            put_norm(f"decoder.layers.{k}.upsample.norm", us["norm"])

    for i, depth in enumerate(cfg.skip_connections):
        for j in range(depth):
            pre = f"residual_blocks.{i}.{j}"
            blk = params[f"residual_{i}_{j}"]
            if cfg.residual_model == "convnext":
                out[f"{pre}.dwconv.weight"] = _conv_w(blk["dwconv"]["kernel"])
                out[f"{pre}.dwconv.bias"] = np.asarray(blk["dwconv"]["bias"])
                out[f"{pre}.pwconv1.weight"] = _linear_w(blk["pwconv1"]["kernel"])
                out[f"{pre}.pwconv1.bias"] = np.asarray(blk["pwconv1"]["bias"])
                out[f"{pre}.pwconv2.weight"] = _linear_w(blk["pwconv2"]["kernel"])
                out[f"{pre}.pwconv2.bias"] = np.asarray(blk["pwconv2"]["bias"])
                out[f"{pre}.weight"] = np.asarray(blk["layer_scale"])
                put_norm(f"{pre}.norm", blk["norm"])
            else:
                for conv in ("conv1", "conv2"):
                    out[f"{pre}.{conv}.weight"] = _conv_w(blk[conv]["kernel"])
                    out[f"{pre}.{conv}.bias"] = np.asarray(blk[conv]["bias"])
                for bn in ("bn1", "bn2"):
                    out[f"{pre}.{bn}.weight"] = np.asarray(blk[bn]["scale"])
                    out[f"{pre}.{bn}.bias"] = np.asarray(blk[bn]["bias"])
                    if batch_stats is not None:
                        st = batch_stats[f"residual_{i}_{j}"][bn]
                        out[f"{pre}.{bn}.running_mean"] = np.asarray(st["mean"])
                        out[f"{pre}.{bn}.running_var"] = np.asarray(st["var"])

    rec = params["patch_recovery"]
    out["patch_recovery.projection.weight"] = _patch_recovery_w(rec["projection"]["kernel"], cfg.patch_size)
    out["patch_recovery.projection.bias"] = np.asarray(rec["projection_bias"])
    out["patch_recovery.mixup.weight"] = _conv_w(rec["mixup"]["kernel"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Checkpoint directories
# ---------------------------------------------------------------------------

def load_config(model_dir: str) -> ScOTConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        return ScOTConfig.from_dict(json.load(f))


def load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """The checkpoint's state dict (safetensors preferred), on the CPU."""
    st_path = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        from safetensors.torch import load_file

        return load_file(st_path)
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"No model.safetensors or pytorch_model.bin in {model_dir}")


def from_pretrained(model_dir: str, device=None, dtype: torch.dtype = torch.float32) -> ScOT:
    """Load a reference-format checkpoint directory into a ScOT on
    ``device`` (default CUDA; raises when CUDA is absent and the caller did
    not ask for the CPU), with compute dtype ``dtype``, in eval mode. Every
    tensor must match (``strict=True``); the mask token is built when the
    checkpoint holds one."""
    dev = resolve_device(device)
    cfg = load_config(model_dir)
    sd = load_state_dict(model_dir)
    model = ScOT(cfg, dtype=dtype, use_mask_token="embeddings.mask_token" in sd)
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()
