"""The train step: the direct (non-autoregressive) branch of
``poseidon_tpu.training.trainer.Trainer._train_step``."""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..models.scot import ScOT, apply_pixel_mask, scot_loss
from .optimizer import clip_by_global_norm, global_norm


def train_step(model: ScOT, optimizer: torch.optim.Optimizer,
               scheduler: torch.optim.lr_scheduler.LRScheduler,
               batch: Mapping[str, torch.Tensor], *, max_grad_norm: Optional[float],
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``batch`` (``pixel_values``, ``labels``, and
    optionally ``time`` and ``pixel_mask``), with the model in train mode:
    forward (dropout and drop-path masks from ``generator``; BatchNorm
    running statistics update) -> ``apply_pixel_mask`` -> ``scot_loss`` ->
    backward -> global norm of the gradients -> clip by it (when
    ``max_grad_norm`` is set and positive) -> ``optimizer.step()`` ->
    ``scheduler.step()`` -> gradients set to None. Returns the loss and the
    norm before clipping, as device tensors (reading them synchronises)."""
    model.train()
    labels = batch["labels"]
    pred = model(batch["pixel_values"], batch.get("time"), generator=generator)
    pred = apply_pixel_mask(pred, labels, batch.get("pixel_mask"))
    loss = scot_loss(pred, labels, model.config)
    loss.backward()
    params = [p for p in model.parameters() if p.requires_grad]
    if max_grad_norm is not None and max_grad_norm > 0:
        gnorm = clip_by_global_norm(params, max_grad_norm)
    else:
        gnorm = global_norm(params)
    optimizer.step()
    scheduler.step()
    optimizer.zero_grad(set_to_none=True)
    return {"loss": loss.detach(), "grad_norm": gnorm}
