"""AdamW with the reference Trainer's four parameter groups, the LR
schedules and global-norm clipping, as ``poseidon_tpu.training.optimizer``
builds them with optax.

Groups, by rules taken in this order:

1. ``embeddings``: every parameter of the embedding (patch embedding, its
   norm, position embeddings, mask token) and of the patch recovery; own
   LR, with weight decay. Only when ``learning_rate_embedding_recovery`` is
   set.
2. ``time_embedding``: the parameters of the ConditionalLayerNorms; own LR,
   no weight decay. Only when ``learning_rate_time_embedding`` is set.
3. ``decay``: everything that is neither in a LayerNorm (plain or
   conditional) nor a bias.
4. ``no_decay``: the rest (biases, norm parameters).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.layers import ConditionalLayerNorm, PlainLayerNorm

GROUPS = ("decay", "no_decay", "embeddings", "time_embedding")
_EMBED_PREFIXES = ("embeddings.", "patch_recovery.")


def label_params(model: nn.Module, use_embeddings_group: bool,
                 use_time_group: bool) -> Dict[str, str]:
    """The group of every trainable parameter, by name."""
    norm_owner = {}
    for mod_name, mod in model.named_modules():
        if isinstance(mod, (PlainLayerNorm, ConditionalLayerNorm)):
            for p_name, _ in mod.named_parameters():
                norm_owner[f"{mod_name}.{p_name}"] = isinstance(mod, ConditionalLayerNorm)
    labels = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if use_embeddings_group and name.startswith(_EMBED_PREFIXES):
            labels[name] = "embeddings"
        elif use_time_group and norm_owner.get(name, False):
            labels[name] = "time_embedding"
        elif name not in norm_owner and "bias" not in name.rsplit(".", 1)[-1]:
            labels[name] = "decay"
        else:
            labels[name] = "no_decay"
    return labels


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps``, then held."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1.0 - min(max(count, 0), steps) / steps) + end


def _cosine(init: float, steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""
    if steps <= 0:
        raise ValueError(f"cosine decay needs positive decay steps, got {steps}")

    def schedule(count):
        c = min(count, steps)
        return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / steps)) + alpha)
    return schedule


def _join(schedules, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules with one boundary."""
    first, second = schedules
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_lr_schedule(kind: str, peak_lr: float, total_steps: int,
                     warmup_ratio: float = 0.0) -> Callable[[int], float]:
    """The LR at each optimizer step (0-based), with optax's semantics:
    cosine or linear decay to 0, or constant, each after a linear warmup of
    ``round(warmup_ratio * total_steps)`` steps. With warmup, cosine counts
    the warmup inside ``total_steps``
    (``warmup_cosine_decay_schedule(0, peak, warmup, total_steps)``);
    linear and constant decay over the steps after it."""
    warmup = int(round(warmup_ratio * total_steps))
    decay = max(total_steps - warmup, 1)
    if kind == "cosine":
        if warmup:
            return _join((_linear(0.0, peak_lr, warmup), _cosine(peak_lr, total_steps - warmup)),
                         warmup)
        return _cosine(peak_lr, decay)
    if kind == "linear":
        if warmup:
            return _join((_linear(0.0, peak_lr, warmup), _linear(peak_lr, 0.0, decay)), warmup)
        return _linear(peak_lr, 0.0, decay)
    if kind in ("constant", "constant_with_warmup"):
        if warmup:
            return _join((_linear(0.0, peak_lr, warmup), lambda count: peak_lr), warmup)
        return lambda count: peak_lr
    raise ValueError(f"Unknown lr scheduler {kind!r}")


def build_optimizer(
    model: nn.Module,
    *,
    learning_rate: float,
    total_steps: int,
    weight_decay: float = 0.0,
    lr_scheduler_type: str = "cosine",
    warmup_ratio: float = 0.0,
    learning_rate_embedding_recovery: Optional[float] = None,
    learning_rate_time_embedding: Optional[float] = None,
    adam_beta1: float = 0.9,
    adam_beta2: float = 0.999,
    adam_epsilon: float = 1e-8,
) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """``torch.optim.AdamW`` with one parameter group per active label (its
    own peak LR and weight decay) and a ``LambdaLR`` that sets each group's
    LR to its schedule at every step: call ``scheduler.step()`` after each
    ``optimizer.step()``. Clipping is separate: :func:`clip_by_global_norm`
    before the step, as optax chains it before the update."""
    use_emb = learning_rate_embedding_recovery is not None
    use_time = learning_rate_time_embedding is not None
    labels = label_params(model, use_emb, use_time)
    settings = {"decay": (learning_rate, weight_decay), "no_decay": (learning_rate, 0.0),
                "embeddings": (learning_rate_embedding_recovery, weight_decay),
                "time_embedding": (learning_rate_time_embedding, 0.0)}
    groups, schedules = [], []
    named = dict(model.named_parameters())
    for label in GROUPS:
        params = [named[n] for n, lab in labels.items() if lab == label]
        if not params:
            continue
        peak, wd = settings[label]
        # lr 1.0 at construction: LambdaLR multiplies it by the schedule's
        # absolute value.
        groups.append({"params": params, "lr": 1.0, "weight_decay": wd, "label": label})
        schedules.append(make_lr_schedule(lr_scheduler_type, peak, total_steps, warmup_ratio))
    optimizer = torch.optim.AdamW(groups, lr=1.0, betas=(adam_beta1, adam_beta2),
                                  eps=adam_epsilon)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, schedules)


def _local(g: torch.Tensor) -> torch.Tensor:
    """The rows of ``g`` this process holds: a DTensor's local shard (a
    view: writing it writes the gradient), else ``g``."""
    from torch.distributed.tensor import DTensor

    return g.to_local() if isinstance(g, DTensor) else g


@torch.no_grad()
def global_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm of the gradients: sqrt of the sum of squares, fp32.
    Gradients sharded as DTensors (FSDP: one mesh, one placement for all)
    count their local shards, summed over the mesh dims they are sharded
    on, so every rank gets the norm of the whole gradient."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    sharded = [g for g in grads if _local(g) is not g]
    total = sum(g.float().pow(2).sum() for g in grads if _local(g) is g)
    if sharded:
        sq = sum(_local(g).float().pow(2).sum() for g in sharded)
        mesh = sharded[0].device_mesh
        for dim, placement in enumerate(sharded[0].placements):
            if placement.is_shard():
                dist.all_reduce(sq, group=mesh.get_group(dim))
        total = total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the gradients, in place: each is scaled
    by ``max_norm / norm`` when ``norm >= max_norm`` and left as it is
    otherwise. (``torch.nn.utils.clip_grad_norm_`` divides by
    ``norm + 1e-6``, another function.) Returns the norm before clipping."""
    params = [p for p in params if p.grad is not None]
    norm = global_norm(params)
    keep = norm < max_norm   # a device tensor: no host synchronisation
    for p in params:
        g = _local(p.grad)
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm
