"""Weight bridge between the JAX package's Flax params and this port.

The port's parameter names are those of the reference PyTorch state dict,
so a Flax params tree goes through :func:`from_jax_params` (the layout
logic of ``poseidon_tpu.hub.export_torch_state_dict`` and
``unroll_scanned_params``, in numpy) and then
``model.load_state_dict(sd, strict=True)``. :func:`from_pretrained` loads a
reference-format checkpoint directory (``config.json`` plus
``model.safetensors`` or ``pytorch_model.bin``), strictly or, given a new
config, by the fine-tune surgery of the reference
(``ignore_mismatched_sizes``); :func:`save_pretrained` writes one.
Safetensors files are read and written by the port's own
``utils/safetensors_io.py``, so no package beyond torch is needed; the Hub
(``huggingface_hub``) is imported only to fetch or push a repository.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .config import ScOTConfig
from .models.scot import ScOT, init_weights
from .utils import safetensors_io
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
        return safetensors_io.load_file(st_path)
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"No model.safetensors or pytorch_model.bin in {model_dir}")


def resolve_model_path(model_dir_or_repo_id: str) -> str:
    """A local checkpoint directory for ``model_dir_or_repo_id``: the path
    itself when it is a directory, else a Hub repository id (e.g.
    ``"camlab-ethz/Poseidon-B"``) fetched by
    ``huggingface_hub.snapshot_download`` into its cache. Raises
    ``FileNotFoundError`` naming the path when neither works."""
    if os.path.isdir(model_dir_or_repo_id):
        return model_dir_or_repo_id
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise FileNotFoundError(
            f"{model_dir_or_repo_id!r} is not a local directory and huggingface_hub "
            "is not installed to download it") from e
    try:
        return snapshot_download(
            repo_id=model_dir_or_repo_id,
            allow_patterns=["config.json", "model.safetensors", "pytorch_model.bin"])
    except Exception as e:
        raise FileNotFoundError(
            f"{model_dir_or_repo_id!r} is not a local checkpoint directory and "
            f"downloading it from the Hub failed ({type(e).__name__}: {e}). Offline, "
            "download it beforehand or pass a local path.") from e


def push_to_hub(repo_id: str, export_dir: str) -> bool:
    """Upload a :func:`save_pretrained` directory to the Hub repository
    ``repo_id``. Returns True on success; the local directory stays either
    way."""
    try:
        from huggingface_hub import HfApi

        api = HfApi()
        api.create_repo(repo_id=repo_id, exist_ok=True)
        api.upload_folder(repo_id=repo_id, folder_path=export_dir)
        return True
    except Exception as e:
        print(f"Hub push to {repo_id!r} failed ({type(e).__name__}: {e}); "
              f"the checkpoint stays at {export_dir}")
        return False


def save_pretrained(model: ScOT, save_dir: str) -> None:
    """Write a reference-format checkpoint directory: ``model.safetensors``
    (the state dict, BatchNorm running statistics included, fp32 on the
    CPU) and ``config.json`` with ``"model_type": "swinv2"``, the layout
    the reference's ``ScOT.from_pretrained`` and the JAX package's
    ``poseidon_tpu.hub.from_pretrained`` read."""
    os.makedirs(save_dir, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    sd = {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}
    safetensors_io.save_file(sd, os.path.join(save_dir, "model.safetensors"))
    d = model.config.to_dict()
    d["model_type"] = "swinv2"
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(d, f, indent=2)


def _merge_with_init(model: torch.nn.Module,
                     loaded: Mapping[str, torch.Tensor]) -> List[str]:
    """Copy every tensor of ``loaded`` whose name and shape fit ``model``'s
    state dict into it; the others keep the model's values. Returns the
    names of ``model``'s state dict that were not loaded (sorted); tensors
    of ``loaded`` the model lacks are ignored (as ``_merge_with_init`` of the
    JAX hub)."""
    own = model.state_dict()
    merged, replaced = {}, []
    for name, val in own.items():
        src = loaded.get(name)
        if src is not None and tuple(src.shape) == tuple(val.shape):
            merged[name] = src.to(val.dtype)
        else:
            replaced.append(name)
            merged[name] = val
    model.load_state_dict(merged, strict=True)
    return sorted(replaced)


def from_pretrained(model_dir: str, config: Optional[ScOTConfig] = None,
                    ignore_mismatched_sizes: bool = False, device=None,
                    dtype: torch.dtype = torch.float32, output_loading_info: bool = False
                    ) -> Union[ScOT, Tuple[ScOT, Dict[str, List[str]]]]:
    """Load a reference-format checkpoint (a local directory, or a Hub
    repository id: :func:`resolve_model_path`) into a ScOT on ``device``
    (default CUDA; raises when CUDA is absent and the caller did not ask
    for the CPU), with compute dtype ``dtype``, in eval mode.

    With ``config=None`` the checkpoint's own ``config.json`` is used and
    every tensor must match (``strict=True``). With a ``config`` (the
    reference's ``ScOT.from_pretrained(path, config=new_config,
    ignore_mismatched_sizes=True)``, the fine-tune surgery) the model is
    built from it with the seeded init of :func:`build_model`, each
    checkpoint tensor whose name and shape fit is copied over it, and the
    rest keep their init: with other channels, the patch embedding and
    recovery tensors. Those are listed and raise ``ValueError`` unless
    ``ignore_mismatched_sizes``. ``output_loading_info=True`` also returns
    ``{"replaced": [names]}`` (the JAX function's third return value). The
    mask token is built when the checkpoint holds one."""
    dev = resolve_device(device)
    model_dir = resolve_model_path(model_dir)
    sd = load_state_dict(model_dir)
    use_mask_token = "embeddings.mask_token" in sd
    if config is None:
        model = ScOT(load_config(model_dir), dtype=dtype, use_mask_token=use_mask_token)
        model.load_state_dict(sd, strict=True)
        replaced: List[str] = []
    else:
        model = ScOT(config, dtype=dtype, use_mask_token=use_mask_token)
        init_weights(model, torch.Generator().manual_seed(0))
        replaced = _merge_with_init(model, sd)
        if replaced and not ignore_mismatched_sizes:
            raise ValueError("Checkpoint/config mismatch for: " + ", ".join(replaced)
                             + " - pass ignore_mismatched_sizes=True to re-initialize them.")
    model = model.to(dev).eval()
    if output_loading_info:
        return model, {"replaced": replaced}
    return model
