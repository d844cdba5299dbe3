"""PyTorch/CUDA port of poseidon_tpu (Poseidon's scOT), for NVIDIA Hopper.

Importing this package imports ``torch`` only: no JAX, and nothing of the
JAX package. The kernels (``ops/``) are built and loaded at first use.
The data layer (``data/``) and the metrics are numpy and h5py; the Trainer
(``training/``) trains, evaluates and predicts on one card, or on several
under ``torchrun`` (``parallel/``: DDP, HSDP). The command lines are
``python -m poseidon_tpu_torch.train`` and
``python -m poseidon_tpu_torch.inference``.
"""

from .config import MODEL_MAP, ScOTConfig, make_config
from .hub import from_jax_params, from_pretrained, save_pretrained
from .models.scot import (
    ScOT,
    apply_pixel_mask,
    build_model,
    forward_with_intermediates,
    forward_with_loss,
    scot_loss,
)
from .data.registry import get_dataset
from .metrics import ChannelGroupMetrics
from .training import (
    Trainer,
    TrainingArguments,
    autoregressive_rollout,
    build_optimizer,
    rollout_with_intermediates,
    train_step,
)

__all__ = [
    "ScOTConfig",
    "MODEL_MAP",
    "make_config",
    "ScOT",
    "build_model",
    "from_pretrained",
    "save_pretrained",
    "from_jax_params",
    "forward_with_intermediates",
    "autoregressive_rollout",
    "rollout_with_intermediates",
    "apply_pixel_mask",
    "forward_with_loss",
    "scot_loss",
    "build_optimizer",
    "train_step",
    "Trainer",
    "TrainingArguments",
    "get_dataset",
    "ChannelGroupMetrics",
]
