"""Training: the grouped AdamW optimizer with its LR schedule, global-norm
clipping, the train step, the rollouts and the Trainer."""

from .arguments import TrainingArguments
from .optimizer import build_optimizer, clip_by_global_norm, label_params, make_lr_schedule
from .rollout import (
    autoregressive_rollout,
    autoregressive_rollout_stateful,
    rollout_loss,
    rollout_with_intermediates,
)
from .trainer import PredictionOutput, Trainer, train_step

__all__ = ["TrainingArguments", "build_optimizer", "clip_by_global_norm", "label_params",
           "make_lr_schedule", "autoregressive_rollout", "autoregressive_rollout_stateful",
           "rollout_loss", "rollout_with_intermediates", "PredictionOutput", "Trainer", "train_step"]
