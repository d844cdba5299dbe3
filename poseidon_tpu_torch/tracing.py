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
autograd sequence number. A step that replays ``train_step``'s CUDA graph
(``training/step_graph.py``) runs its work on the device alone: its
``scot.train_step`` holds one ``scot.train_step.replay`` and none of the
phases or block parts. So does a ScOT forward that replays its own graph
(``models/forward_graph.py``: on CUDA, without autograd, in eval mode or at
zero dropout, at the configured image size): one ``scot.forward.replay``
and no block parts, inside ``scot.rollout`` where the rollout calls it. A
forward's graph keeps its memory pool reserved until the model changes
mode or is deleted.

:func:`graph_counts` says how ``train_step`` ran in this process: the
graph's captures and replays, and the eager steps by reason.
:func:`forward_graph_counts` says the same of ``ScOT.forward``.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict

import torch

_OFF = contextlib.nullcontext()

# Why a train step ran eagerly, in the order ``step_graph.eager_reason``
# tests them; ``first`` is the eager step that starts a new step key.
EAGER_REASONS = ("cpu", "group", "loss_fn", "generator", "masks", "capturing", "optimizer",
                 "grads", "first")
_STEPS: collections.Counter = collections.Counter()
# Why a ScOT forward ran eagerly, in the order ``forward_graph.eager_reason``
# tests them; ``first`` is an eager call of a key that is not the graph's.
FORWARD_EAGER_REASONS = ("cpu", "grad", "masks", "capturing", "masked", "resized",
                         "intermediates", "collective", "first")
_FORWARDS: collections.Counter = collections.Counter()


def span(name: str):
    """The range ``scot.<name>`` while a profiler records, else a no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function("scot." + name)
    return _OFF


def count_step(kind: str) -> None:
    """Add one to the train steps of ``kind``: ``captures``, ``replays`` or
    ``eager.<reason>`` (a reason of :data:`EAGER_REASONS`)."""
    _STEPS[kind] += 1


def graph_counts() -> Dict[str, object]:
    """The train steps since the process started: ``captures`` (a capture's
    call also replays once), ``replays``, and ``eager`` by reason (every
    reason of :data:`EAGER_REASONS`, 0 where none)."""
    return {"captures": _STEPS["captures"], "replays": _STEPS["replays"],
            "eager": {r: _STEPS["eager." + r] for r in EAGER_REASONS}}


def count_forward(kind: str) -> None:
    """Add one to the ScOT forwards of ``kind``: ``captures``, ``replays``
    or ``eager.<reason>`` (a reason of :data:`FORWARD_EAGER_REASONS`)."""
    _FORWARDS[kind] += 1


def forward_graph_counts() -> Dict[str, object]:
    """The ScOT forwards since the process started: ``captures`` (a
    capture's call also replays once), ``replays``, and ``eager`` by reason
    (every reason of :data:`FORWARD_EAGER_REASONS`, 0 where none)."""
    return {"captures": _FORWARDS["captures"], "replays": _FORWARDS["replays"],
            "eager": {r: _FORWARDS["eager." + r] for r in FORWARD_EAGER_REASONS}}
