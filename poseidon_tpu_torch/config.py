"""Model configuration of the PyTorch port of scOT (Poseidon).

The same fields, defaults and named sizes as ``poseidon_tpu.config``, so a
``config.json`` written by the JAX package loads here unchanged. Kept as a
copy: the JAX package's ``__init__`` imports flax.

``attention_impl`` keeps its JAX spelling: ``"xla"`` selects the plain
PyTorch path, ``"pallas"`` the hand-written Hopper kernels
(``ops/window_attention.py``, ``ops/mlp.py``, ``ops/norm.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ScOTConfig:
    """Static architecture + loss configuration."""

    image_size: int = 224
    patch_size: int = 4
    num_channels: int = 3
    num_out_channels: int = 1
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    skip_connections: Tuple[int, ...] = (2, 2, 2, 0)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    drop_path_rate: float = 0.1
    hidden_act: str = "gelu"
    use_absolute_embeddings: bool = False
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    # p-norm of the training loss: 1 -> L1, 2 -> L2.
    p: int = 1
    # Cumulative channel-group boundaries for the normalized loss, e.g.
    # (0, 1, 3, 4) for "[rho],[u,v],[p]".
    channel_slice_list_normalized_loss: Optional[Tuple[int, ...]] = None
    # Residual skip-block family: "convnext" or "resnet".
    residual_model: str = "convnext"
    # Lead-time conditioning via ConditionalLayerNorm.
    use_conditioning: bool = False
    # Predict the residual w.r.t. the input; forced off without conditioning.
    learn_residual: bool = False
    # "xla": plain PyTorch; "pallas": the hand-written Hopper kernels.
    attention_impl: str = "xla"
    # Score dtype of the plain attention path: "float32" or "bfloat16".
    # The kernel path always forms scores in fp32 from bf16 operands.
    score_dtype: str = "float32"
    # JAX-only layout switch (scanned block pairs). The port always runs
    # unrolled blocks; hub.from_jax_params unrolls scanned params.
    scan_blocks: bool = False
    # The fused MLP + conditional norm + residual kernel of the block tail
    # (ops/mlp.py::mlp_cln): with attention_impl="pallas" and conditioning,
    # taken at the stages ops/mlp.py::use_fused_tail picks.
    fused_block_tail: bool = False
    # JAX-only token-tile gate of the TPU MLP kernel. Kept so JAX configs
    # load; the port dispatches with its own rule (ops/mlp.py).
    mlp_min_win_tile: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "depths", tuple(self.depths))
        object.__setattr__(self, "num_heads", tuple(self.num_heads))
        object.__setattr__(self, "skip_connections", tuple(self.skip_connections))
        if self.channel_slice_list_normalized_loss is not None:
            object.__setattr__(
                self,
                "channel_slice_list_normalized_loss",
                tuple(self.channel_slice_list_normalized_loss),
            )
        if not self.use_conditioning and self.learn_residual:
            object.__setattr__(self, "learn_residual", False)
        if self.residual_model not in ("convnext", "resnet"):
            raise ValueError("residual_model must be 'convnext' or 'resnet'")
        if self.p not in (1, 2):
            raise ValueError("p must be 1 or 2")
        if self.attention_impl not in ("xla", "pallas"):
            raise ValueError("attention_impl must be 'xla' or 'pallas'")

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    @property
    def hidden_size(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    def stage_dim(self, i: int) -> int:
        return int(self.embed_dim * 2**i)

    def stage_resolution(self, i: int) -> int:
        return self.grid_size // (2**i)

    def stage_window_and_shift(self, i: int, shifted: bool) -> Tuple[int, int]:
        """Window size and shift for stage ``i``: the window is clamped to
        the stage resolution, and the shift is off when one window covers
        the stage."""
        res = self.stage_resolution(i)
        window = min(self.window_size, res)
        shift = (self.window_size // 2) if (shifted and res > window) else 0
        return window, shift

    def replace(self, **kwargs) -> "ScOTConfig":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ScOTConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ScOTConfig":
        return cls.from_dict(json.loads(s))


# Named model sizes. All share heads/skips/window/patch/mlp_ratio; T/S differ
# in depth, S/B/L in width.
_COMMON = dict(
    num_heads=(3, 6, 12, 24),
    skip_connections=(2, 2, 2, 0),
    window_size=16,
    patch_size=4,
    mlp_ratio=4.0,
)

MODEL_MAP = {
    "T": dict(_COMMON, depths=(4, 4, 4, 4), embed_dim=48),
    "S": dict(_COMMON, depths=(8, 8, 8, 8), embed_dim=48),
    "B": dict(_COMMON, depths=(8, 8, 8, 8), embed_dim=96),
    "L": dict(_COMMON, depths=(8, 8, 8, 8), embed_dim=192),
}


def make_config(
    model_name: str = "B",
    *,
    image_size: int = 128,
    num_channels: int,
    num_out_channels: int,
    channel_slice_list: Optional[Sequence[int]] = None,
    use_conditioning: bool = True,
    **overrides,
) -> ScOTConfig:
    """Config for a named size with the training defaults: qkv_bias on,
    dropouts 0, no absolute embeddings, L1 channel-group-normalized loss,
    convnext skip blocks."""
    if model_name not in MODEL_MAP:
        raise ValueError(f"Unknown model size {model_name!r}; choose from {sorted(MODEL_MAP)}")
    base = dict(
        image_size=image_size,
        num_channels=num_channels,
        num_out_channels=num_out_channels,
        qkv_bias=True,
        hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
        drop_path_rate=0.0,
        hidden_act="gelu",
        use_absolute_embeddings=False,
        initializer_range=0.02,
        layer_norm_eps=1e-5,
        p=1,
        channel_slice_list_normalized_loss=(
            tuple(channel_slice_list) if channel_slice_list is not None else None
        ),
        residual_model="convnext",
        use_conditioning=use_conditioning,
        learn_residual=False,
    )
    base.update(MODEL_MAP[model_name])
    if model_name == "L":
        # Same default as the JAX package, so the two configs compare equal.
        base["mlp_min_win_tile"] = 128
    base.update(overrides)
    return ScOTConfig(**base)
