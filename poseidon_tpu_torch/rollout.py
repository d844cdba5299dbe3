"""Autoregressive rollout, mirroring
``poseidon_tpu.training.rollout.autoregressive_rollout``:

- int ``ar_steps`` n: the lead time is divided by n and the model is
  applied n times, each output fed back as the next input;
- list ``ar_steps``: the time of step i is ``lead_time * ar_steps[i]``;
- when the model has static input channels (num_channels >
  num_out_channels), those channels of the original input are re-attached
  to each fed-back prediction;
- ``output_all_steps`` stacks every prediction on a new time axis
  (B, n, C_out, H, W).

A Python loop under ``torch.no_grad()``; the fed-back input is detached.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import torch

from .utils.device import resolve_device

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
