"""The reference's training step and rollout.

The step: the loss of the whole batch, computed in blocks of rows whose
gradients add up; the global gradient norm; clipping by it (scaled by
max / norm when the norm reaches max); AdamW with decoupled weight decay in
two groups (no decay for biases and the conditional norms' weights); the
cosine schedule without warmup, one value per step counted from 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from .scot import Params, Reference, is_norm_param


def decays(name: str) -> bool:
    return not is_norm_param(name) and "bias" not in name.rsplit(".", 1)[-1]


def cosine_lr(opt: dict, step: int) -> float:
    total = opt["total_steps"]
    return opt["learning_rate"] * 0.5 * (1.0 + math.cos(math.pi * min(step, total) / total))


class AdamW:
    """AdamW over ``params`` as the configurations state it."""

    def __init__(self, params: Params, opt: dict):
        self.params, self.opt, self.count = params, opt, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Params) -> None:
        b1, b2, eps = self.opt["betas"][0], self.opt["betas"][1], self.opt["eps"]
        lr = cosine_lr(self.opt, self.count)
        self.count += 1
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for name, p in self.params.items():
            g = grads[name]
            if decays(name):
                p.mul_(1.0 - lr * self.opt["weight_decay"])
            self.m[name].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[name].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[name].sqrt() / math.sqrt(c2)).add_(eps)
            p.addcdiv_(self.m[name], denom, value=-lr / c1)


def loss_and_grads(ref: Reference, params: Params, batch: Dict[str, torch.Tensor],
                   rows: int, with_grad: bool = True):
    """The batch's loss and (``with_grad``) its gradient, ``rows`` rows at a
    time."""
    labels = batch["labels"]
    norms = [n.detach() for n in ref.label_norms(labels)]
    n = labels.shape[0]
    for p in params.values():
        p.requires_grad_(with_grad)
        p.grad = None
    total = torch.zeros((), device=labels.device)
    for lo in range(0, n, rows):
        part = {k: v[lo:lo + rows] for k, v in batch.items()}
        with torch.set_grad_enabled(with_grad):
            pred = ref.forward(params, part["pixel_values"], part["time"])
            loss = ref.loss(ref.loss_terms(pred, part["labels"], part.get("pixel_mask")),
                            norms, n, labels.shape)
            if with_grad:
                loss.backward()
        total += loss.detach()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in params.items()} if with_grad else None
    for p in params.values():
        p.requires_grad_(False)
        p.grad = None
    return total, grads


def train_steps(ref: Reference, params: Params, batches: Sequence[Dict[str, torch.Tensor]],
                opt: dict, max_grad_norm: float, rows: int) -> dict:
    """Steps on ``batches`` from ``params`` (updated in place). Returns each
    step's loss and gradient norm before clipping, the first step's clipped
    gradient norm by leaf, and the norm of each leaf's gradient at the first
    step before clipping (which leaves round-off alone moves)."""
    adam = AdamW(params, opt)
    losses, norms, first, first_raw = [], [], {}, {}
    for i, batch in enumerate(batches):
        loss, grads = loss_and_grads(ref, params, batch, rows)
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if i == 0:
            first_raw = {k: float(g.norm()) for k, g in grads.items()}
        if float(norm) >= max_grad_norm:
            grads = {k: g / norm * max_grad_norm for k, g in grads.items()}
        if i == 0:
            first = {k: float(g.norm()) for k, g in grads.items()}
        adam.step(grads)
        losses.append(float(loss))
        norms.append(float(norm))
        del grads
    return {"losses": losses, "grad_norms": norms, "first_grad": first,
            "first_grad_raw": first_raw}


@torch.no_grad()
def rollout(ref: Reference, params: Params, pixel_values: torch.Tensor, time: torch.Tensor,
            ar_steps: int, rows: int) -> torch.Tensor:
    """(B, ar_steps, C_out, H, W): each step at time / ar_steps, its
    prediction fed back with the static input channels re-attached."""
    outs = []
    for lo in range(0, pixel_values.shape[0], rows):
        x, t = pixel_values[lo:lo + rows].float(), time[lo:lo + rows].float() / ar_steps
        steps: List[torch.Tensor] = []
        for _ in range(ar_steps):
            pred = ref.forward(params, x, t)
            steps.append(pred)
            c = pred.shape[1]
            x = torch.cat([pred, x[:, c:]], 1) if x.shape[1] > c else pred
        outs.append(torch.stack(steps, 1))
    return torch.cat(outs)
