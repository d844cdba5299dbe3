"""Named ranges of the port in the torch profiler's own timeline.

``span(name)`` is ``torch.profiler.record_function("scot." + name)`` while
a torch profiler records (the benchmark's profiled calls, the Trainer's
``profile_step_start`` window, any caller's ``torch.profiler.profile``),
and one shared context that does nothing otherwise: off, a span costs a
check of the profiler's state. The spans, opened in forward code only:

- ``scot.train_step`` (``training/trainer.py::train_step``), with its phases
  ``scot.forward`` (the loss), ``scot.backward`` and ``scot.optimizer``
  (global norm and clip, the optimizer's and the scheduler's step,
  ``zero_grad``);
- ``scot.rollout`` (``training/rollout.py::autoregressive_rollout``);
- in each ``SwinBlock.forward`` (``models/scot.py``):
  ``scot.block.attention`` (pad, roll, partition, the window attention,
  reverse, roll back, crop), ``scot.block.norm`` (the conditional
  LayerNorms outside the fused tail) and ``scot.block.mlp`` (the MLP and its
  dropout, or the fused tail with its scale and shift).

The backward runs under ``scot.backward`` and opens no span: a reader of the
trace charges a backward op to the block part of the forward op with its
autograd sequence number.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """The range ``scot.<name>`` while a profiler records, else a no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function("scot." + name)
    return _OFF
