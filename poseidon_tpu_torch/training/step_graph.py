"""The train step as one CUDA graph, which ``trainer.train_step`` captures
and replays wherever the call allows it.

A call can be captured when its parameters and batch are on CUDA, it has no
data group, no ``loss_fn`` and no ``generator``, the model draws no dropout
or drop-path masks (drop-path draws them on the host without a generator),
no capture is under way, the optimizer has a ``capturable`` mode and none
of its parameters holds a gradient from before the call (the step would
add to it). :func:`eager_reason` names the first of these a call fails;
such a call runs the eager step, as the Trainer's steps, data parallelism,
the CPU and an outer capture do.

The graph belongs to a *step key* (:func:`step_key`): the model and the
optimizer, the addresses of the parameters, buffers, optimizer state and
device LRs, each group's settings, the batch's shapes, dtypes and devices,
``max_grad_norm`` and the model's mode. With a key it has not seen, a call

1. makes the optimizer capturable (:func:`make_capturable`: AdamW's step
   counters on the device and each group's LR in a 0-dim device tensor,
   which ``LambdaLR`` then writes with ``fill_``) and takes the step
   eagerly on the device's side stream (``forward_graph.side_stream``,
   which every graph shares): AdamW's state is created and the
   kernels' first use (build, load, launch attributes) stays out of the
   capture;

the next call with that key

2. copies the batch into static buffers, captures the step (forward,
   backward, global norm and clip, ``optimizer.step()``, ``zero_grad``)
   into the graph's private memory pool and replays it once
   (``torch.cuda.graph`` synchronizes and empties the allocator's cache
   first, so the eager steps' blocks go back to the card before the pool
   takes the step's);

and every later call

3. copies the batch into the static buffers, replays the graph, and steps
   the scheduler outside it (a captured ``fill_`` would freeze the LR).

A replay first waits until the replay ``RUN_AHEAD`` calls earlier has ended,
so the host runs at most that many steps ahead of the card (the graph's
bookkeeping, ``models/forward_graph.py::Graph``, is the forward graph's
too). The loss and norm returned are clones, one pair a call. A new key drops the old graph.
The graph lives in a ``WeakKeyDictionary`` keyed by the optimizer and
holds no reference to it or to the model: deleting the optimizer frees the
graph and its pool.

Every step under the graph, the eager first one too, runs capturable
AdamW's arithmetic: the same update in fp32, rounded otherwise than the
default one.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Callable, Dict, Mapping, Optional

import torch

from ..models import forward_graph
from ..models.forward_graph import Graph
from ..tracing import count_step, span

# ``step(batch, scheduler)``: the step's work on ``batch``; ``scheduler``
# None leaves the schedule's step to the caller.
StepFn = Callable[[Mapping[str, torch.Tensor], Optional[object]], Dict[str, torch.Tensor]]


def on_cuda(model: torch.nn.Module, batch: Mapping[str, torch.Tensor]) -> bool:
    """The model's first parameter and every tensor of the batch are on CUDA."""
    return forward_graph.on_cuda(model, *batch.values())


def draws_masks(model: torch.nn.Module) -> bool:
    """The model's step draws dropout or drop-path masks. Without a
    generator, drop-path draws them on the host, which a graph would replay
    as constants."""
    cfg = model.config
    return (cfg.hidden_dropout_prob > 0.0 or cfg.attention_probs_dropout_prob > 0.0
            or cfg.drop_path_rate > 0.0)


def eager_reason(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 batch: Mapping[str, torch.Tensor], *, group, loss_fn,
                 generator) -> Optional[str]:
    """Why ``train_step`` takes this call eagerly (a reason of
    ``tracing.EAGER_REASONS``), or None where it can be captured."""
    if not on_cuda(model, batch):
        return "cpu"
    if group is not None:
        return "group"
    if loss_fn is not None:
        return "loss_fn"
    if generator is not None:
        return "generator"
    if draws_masks(model):
        return "masks"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    if "capturable" not in optimizer.defaults:
        return "optimizer"
    if any(p.grad is not None for g in optimizer.param_groups for p in g["params"]):
        return "grads"
    return None


def _address(v):
    return v.data_ptr() if torch.is_tensor(v) else v


def step_key(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
             batch: Mapping[str, torch.Tensor], max_grad_norm: Optional[float]) -> tuple:
    """What a captured step is bound to; a call whose key differs cannot
    replay it."""
    return (id(model), id(optimizer), model.training, max_grad_norm,
            tuple((t.data_ptr(), t.requires_grad) for m in model.modules()
                  for t in itertools.chain(m._parameters.values(), m._buffers.values())
                  if t is not None),
            tuple(tuple((k, _address(v)) for k, v in g.items() if k != "params")
                  for g in optimizer.param_groups),
            tuple(_address(v) for s in optimizer.state.values() for v in s.values()),
            tuple((k, None if batch[k] is None else
                   (tuple(batch[k].shape), batch[k].dtype, batch[k].device))
                  for k in sorted(batch)))


def make_capturable(optimizer: torch.optim.Optimizer, device: torch.device) -> None:
    """Set ``capturable``, give each group its LR as a 0-dim tensor on
    ``device`` (a tensor there already is kept) and move AdamW's step
    counters to their parameters' devices. The scheduler's ``base_lrs``,
    taken at its construction, stay floats."""
    optimizer.defaults["capturable"] = True
    for group in optimizer.param_groups:
        group["capturable"] = True
        lr = group["lr"]
        if not (torch.is_tensor(lr) and lr.device == device):
            group["lr"] = torch.tensor(float(lr), device=device)
    for p, state in optimizer.state.items():
        step = state.get("step")
        if torch.is_tensor(step) and step.device != p.device:
            state["step"] = step.to(p.device)


_GRAPHS: "weakref.WeakKeyDictionary[torch.optim.Optimizer, Graph]" = weakref.WeakKeyDictionary()


def graphed_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, scheduler,
                 batch: Mapping[str, torch.Tensor], max_grad_norm: Optional[float],
                 step: StepFn) -> Dict[str, torch.Tensor]:
    """One train step of a call :func:`eager_reason` admits: the eager
    first step of a new key, the capture, or a replay (module docstring)."""
    key = step_key(model, optimizer, batch, max_grad_norm)
    g = _GRAPHS.get(optimizer)
    if g is None or g.key != key:
        if g is not None:
            g.drain()   # replays in flight still use the pool it frees
            del _GRAPHS[optimizer]
        device = next(model.parameters()).device
        make_capturable(optimizer, device)
        g = Graph(device, count_step)
        out = g.eager(lambda: step(batch, scheduler))
        g.key = step_key(model, optimizer, batch, max_grad_norm)
        _GRAPHS[optimizer] = g
        count_step("eager.first")
        return out
    if g.graph is None:
        try:
            g.capture(batch, lambda static: step(static, None))
        except BaseException:
            _GRAPHS.pop(optimizer, None)
            raise
    else:
        with span("train_step.replay"):
            g.replay(batch)
    scheduler.step()
    return {k: v.clone() for k, v in g.out.items()}
