"""Training: the grouped AdamW optimizer with its LR schedule, global-norm
clipping, and the train step."""

from .optimizer import build_optimizer, clip_by_global_norm, label_params, make_lr_schedule
from .trainer import train_step

__all__ = ["build_optimizer", "clip_by_global_norm", "label_params", "make_lr_schedule",
           "train_step"]
