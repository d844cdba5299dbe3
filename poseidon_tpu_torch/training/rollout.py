"""Autoregressive rollout, mirroring ``poseidon_tpu.training.rollout``:

- int ``ar_steps`` n: the lead time is divided by n and the model is
  applied n times, each output fed back as the next input;
- list ``ar_steps``: the time of step i is ``lead_time * ar_steps[i]``;
- when the model has static input channels (num_channels >
  num_out_channels), those channels of the original input are re-attached
  to each fed-back prediction;
- ``output_all_steps`` stacks every prediction on a new time axis
  (B, n, C_out, H, W).

:func:`autoregressive_rollout` serves: a Python loop under
``torch.no_grad()``. :func:`autoregressive_rollout_stateful` and
:func:`rollout_loss` train: the fed-back input is detached, so each step's
loss has gradients through its own forward only (the reference detaches
between steps), and BatchNorm running statistics (the resnet residual
variant), which PyTorch keeps in the model's buffers, are updated step
after step in train mode. :func:`rollout_with_intermediates` also stacks
each step's hidden states and attention probabilities.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

from ..models.scot import forward_with_intermediates
from ..utils.device import resolve_device

StepFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x, time) -> prediction


def _step_times(time: torch.Tensor, ar_steps: Union[int, Sequence[float]]) -> torch.Tensor:
    if isinstance(ar_steps, int):
        return (time / ar_steps).expand(ar_steps, *time.shape)
    factors = torch.as_tensor(list(ar_steps), dtype=time.dtype, device=time.device)
    return factors[:, None] * time[None, :]


@torch.no_grad()
def autoregressive_rollout(step_fn: StepFn, pixel_values, time,
                           ar_steps: Union[int, Sequence[float]],
                           num_out_channels: int, output_all_steps: bool = False,
                           device=None) -> torch.Tensor:
    """Run the rollout on ``device`` (default CUDA; raises when CUDA is
    absent and the caller did not ask for the CPU). ``pixel_values`` and
    ``time`` (tensors or arrays) are moved there. Returns the final
    prediction (B, C_out, H, W), or all of them (B, n, C_out, H, W)."""
    dev = resolve_device(device)
    x = torch.as_tensor(pixel_values, dtype=torch.float32, device=dev)
    t = torch.as_tensor(time, dtype=torch.float32, device=dev)
    static = x[:, num_out_channels:] if x.shape[1] > num_out_channels else None
    preds = []
    for step_time in _step_times(t, ar_steps):
        pred = step_fn(x, step_time)
        preds.append(pred)
        fed = pred.detach()
        x = torch.cat([fed, static], dim=1) if static is not None else fed
    if output_all_steps:
        return torch.stack(preds, dim=1)
    return preds[-1][:, :num_out_channels]


def _next_input(pred: torch.Tensor, static: Optional[torch.Tensor]) -> torch.Tensor:
    fed = pred.detach()
    return torch.cat([fed, static], dim=1) if static is not None else fed


def autoregressive_rollout_stateful(step_fn: Callable, pixel_values: torch.Tensor,
                                    time: torch.Tensor, ar_steps: Union[int, Sequence[float]],
                                    num_out_channels: int,
                                    state: Any = None) -> Tuple[torch.Tensor, Any]:
    """The rollout of a step that carries state and receives its index:
    ``step_fn(x, time, step_index, state) -> (prediction, new_state)``, as
    the JAX function's (there the BatchNorm statistics and the per-step
    dropout key). Runs on the inputs' device with autograd on; the
    fed-back input is detached. Returns ``(predictions (B, n, C_out, H, W),
    final_state)``."""
    static = pixel_values[:, num_out_channels:] if pixel_values.shape[1] > num_out_channels \
        else None
    x, preds = pixel_values, []
    for i, step_time in enumerate(_step_times(time, ar_steps)):
        pred, state = step_fn(x, step_time, i, state)
        preds.append(pred)
        x = _next_input(pred, static)
    return torch.stack(preds, dim=1), state


def rollout_loss(step_fn: StepFn, loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 pixel_values: torch.Tensor, time: torch.Tensor, labels: torch.Tensor,
                 ar_steps: Union[int, Sequence[float]],
                 num_out_channels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of the per-step losses against the (final) labels, as the
    reference accumulates during AR prediction; returns (loss, final
    prediction)."""
    preds, _ = autoregressive_rollout_stateful(
        lambda x, t, i, st: (step_fn(x, t), st), pixel_values, time, ar_steps,
        num_out_channels)
    losses = [loss_fn(preds[:, i], labels) for i in range(preds.shape[1])]
    return torch.stack(losses).mean(), preds[:, -1]


def rollout_with_intermediates(model, pixel_values: torch.Tensor, time: torch.Tensor,
                               ar_steps: Union[int, Sequence[float]], **kwargs):
    """The rollout that also stacks every step's hidden states and attention
    probabilities on a new axis 1, as the reference's ``output_all_steps``
    surface and ``poseidon_tpu.training.rollout.rollout_with_intermediates``:
    an eager loop of ``models.scot.forward_with_intermediates`` (``kwargs``
    go to it), each prediction fed back detached with the static channels.
    Runs on the inputs' device, autograd as the caller has it. Returns
    ``(predictions (B, n, C_out, H, W), hidden_states, attentions)``, the
    latter two lists with one (B, n, ...) tensor a layer."""
    num_out = model.config.num_out_channels
    static = pixel_values[:, num_out:] if pixel_values.shape[1] > num_out else None
    x, preds, hs_steps, attn_steps = pixel_values, [], [], []
    for step_time in _step_times(time, ar_steps):
        pred, hs, attn = forward_with_intermediates(model, x, step_time, **kwargs)
        preds.append(pred)
        hs_steps.append(hs)
        attn_steps.append(attn)
        x = _next_input(pred, static)

    def stack(per_step):
        return [torch.stack(layer, dim=1) for layer in zip(*per_step)]

    return torch.stack(preds, dim=1), stack(hs_steps), stack(attn_steps)
