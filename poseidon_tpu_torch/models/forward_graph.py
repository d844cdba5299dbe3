"""ScOT's forward as one CUDA graph, which ``ScOT.forward`` replays on the
calls without autograd that allow it; and the graph bookkeeping that the
train step's graph (``training/step_graph.py``) shares.

A call can be captured when its parameters and inputs are on CUDA,
autograd is off (``torch.no_grad`` or ``torch.inference_mode``), the
model draws no dropout or drop-path masks (eval mode, or zero rates), no
capture is under way (``train_step``'s and ``bench_torch.GraphStep``'s run
the forward eagerly inside their own graph), ``bool_masked_pos`` is None,
the input is at the configured ``image_size`` (the FFT resampling copies a
host index to the card on every call), no ``forward_with_intermediates``
is collecting (its lists are filled on the host), and the forward
communicates nothing (the model is not sharded by FSDP, and no BatchNorm
reduces over a data group in train mode). :func:`eager_reason` names the
first of these a call fails; such a call runs the eager body
(``ScOT.eager_forward``) unchanged. In eval mode ``generator`` draws
nothing and does not matter.

The graph belongs to a *forward key* (:func:`forward_key`): the addresses
of the model's parameters and buffers, its mode, the inputs' shapes,
dtypes and devices, whether ``time`` is None, whether inference mode is on
(a static buffer made under it cannot be written outside it), and the
matmul precision and autocast settings. The inputs' strides are not in it:
the copy into the static buffers takes any layout, and the forward's first
op (``PatchEmbed``'s patch reshape) copies the input into one layout
whatever its strides, so a rollout's first input (contiguous) and its fed
back predictions (the forward's NHWC-strided output) share one graph. A
model holds at most one graph. A call whose key

1. is the graph's copies its inputs into the static buffers, replays the
   graph and returns a clone of the static output: every call's output is
   its own tensor;
2. is the previous call's, its second call in a row, drops the graph (after
   the replays still in flight), copies the inputs into static buffers,
   captures the forward into a new graph's private memory pool
   (``torch.cuda.graph`` synchronizes and empties the allocator's cache
   first) and replays it once;
3. is neither runs the eager body on the side stream that captures, so
   that the kernels' first use (build, load, launch attributes, the
   stream's cuBLAS workspace) stays out of the capture, and leaves the
   graph in place: a short last batch does not evict the main shape.

A replay first waits until the replay ``RUN_AHEAD`` calls earlier has
ended, as a train replay does, and adds the launches its capture counted
to ``ops``' counters. It runs the eager body's kernels in the same order,
so it gives the same bits. The graphs live in a ``WeakKeyDictionary`` keyed
by the model and hold no reference to it. The graph's pool stays reserved
until the model changes mode (``ScOT.train`` calls :func:`release`: a
Trainer that evaluates between epochs does not carry it through training)
or is deleted; the allocator hands a released pool back to the card when it
next empties its cache or runs short.
"""

from __future__ import annotations

import collections
import gc
import sys
import weakref
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn as nn

from .. import ops
from ..tracing import count_forward, span

RUN_AHEAD = 2


# One side stream a device serves every graph, the train step's and the
# forward's: PyTorch keeps a cuBLAS workspace (~32 MiB) for each stream it
# has run a product on, for the life of the process.
_STREAMS: Dict[int, torch.cuda.Stream] = {}


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream on which the graphs of ``device`` capture and run their
    eager first calls."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


class Graph:
    """The device's side stream and, once captured, a CUDA graph with its
    static inputs and output, the kernel launches its capture counted and
    the events of the replays still in flight. ``count(kind)`` records
    ``captures`` and ``replays``. ``capture_error_mode`` is
    ``torch.cuda.graph``'s: under ``"global"`` a CUDA call of another
    thread that is unsafe during a capture fails the capture."""

    capture_error_mode = "global"

    def __init__(self, device: torch.device, count: Callable[[str], None]):
        self.key = None
        self.stream = side_stream(device)
        self.graph = None
        self.static: Dict[str, Optional[torch.Tensor]] = {}
        self.out = None
        self.launches: Dict[str, int] = {}
        self.pending: collections.deque = collections.deque()
        self.count = count

    def eager(self, fn: Callable[[], object]):
        """``fn()`` on the side stream, ordered after the current stream's
        work and before its next."""
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def capture(self, inputs: Mapping[str, Optional[torch.Tensor]],
                fn: Callable[[Mapping[str, Optional[torch.Tensor]]], object]) -> None:
        """Capture ``fn`` on static copies of ``inputs`` and replay it once.

        The cyclic garbage collector waits until the capture has ended:
        collecting a dead cycle that holds another graph (an optimizer and
        its scheduler form one) destroys that graph, a call no capture
        permits, and ``torch.cuda.graph`` no longer collects before it
        begins. A capture that fails retires its stream: the allocator may
        still send the stream's allocations to the failed graph's pool."""
        self.static = {k: None if v is None else v.clone() for k, v in inputs.items()}
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode=self.capture_error_mode):
                self.out = fn(self.static)
        except BaseException:
            for index, stream in list(_STREAMS.items()):
                if stream is self.stream:
                    del _STREAMS[index]
            raise
        finally:
            if collecting:
                gc.enable()
        after = ops.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        self.graph = graph
        graph.replay()   # the capture's own launches are counted already
        self.count("captures")
        self.count("replays")

    def replay(self, inputs: Mapping[str, Optional[torch.Tensor]]) -> None:
        if len(self.pending) == RUN_AHEAD:
            self.pending.popleft().synchronize()
        for k, v in inputs.items():
            if v is not None:
                self.static[k].copy_(v)
        self.graph.replay()
        event = torch.cuda.Event()
        event.record()
        self.pending.append(event)
        ops.add_launch_counts(self.launches)
        self.count("replays")

    def drain(self) -> None:
        """Wait for the replays in flight: they still use the pool."""
        for event in self.pending:
            event.synchronize()
        self.pending.clear()

    def drop(self) -> None:
        """Free the graph, its static tensors and so its pool."""
        self.drain()
        self.key = self.graph = self.out = None
        self.static, self.launches = {}, {}


def on_cuda(model: nn.Module, *tensors: Optional[torch.Tensor]) -> bool:
    """The model's first parameter and every tensor given are on CUDA."""
    first = next(model.parameters(), None)
    return (first is not None and first.is_cuda
            and all(t.is_cuda for t in tensors if t is not None))


def draws_masks(model: nn.Module) -> bool:
    """The model's forward draws dropout or drop-path masks: train mode and
    a rate above zero."""
    cfg = model.config
    return model.training and (cfg.hidden_dropout_prob > 0.0
                               or cfg.attention_probs_dropout_prob > 0.0
                               or cfg.drop_path_rate > 0.0)


def communicates(model: nn.Module) -> bool:
    """The forward runs collectives: FSDP gathers the model's parameters,
    or in train mode a BatchNorm reduces its statistics over a group."""
    fsdp = sys.modules.get("torch.distributed.fsdp")
    if fsdp is not None and isinstance(model, getattr(fsdp, "FSDPModule", ())):
        return True
    return model.training and any(getattr(m, "process_group", None) is not None
                                  for m in model.modules())


def eager_reason(model: nn.Module, pixel_values: torch.Tensor, time: Optional[torch.Tensor],
                 bool_masked_pos: Optional[torch.Tensor]) -> Optional[str]:
    """Why ``ScOT.forward`` runs this call eagerly (a reason of
    ``tracing.FORWARD_EAGER_REASONS``), or None where it can be captured."""
    if not on_cuda(model, pixel_values, time):
        return "cpu"
    if torch.is_grad_enabled():
        return "grad"
    if draws_masks(model):
        return "masks"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    if bool_masked_pos is not None:
        return "masked"
    size = model.config.image_size
    if pixel_values.shape[-2] != size or pixel_values.shape[-1] != size:
        return "resized"
    if model.encoder.capture is not None:
        return "intermediates"
    if communicates(model):
        return "collective"
    return None


def _addresses(module: nn.Module, out: list) -> None:
    # A walk of the module tree by hand: on ScOT-B's 1,716 tensors it takes
    # under half of ``Module.modules()``'s host time.
    for t in module._parameters.values():
        if t is not None:
            out.append(t.data_ptr())
    for t in module._buffers.values():
        if t is not None:
            out.append(t.data_ptr())
    for child in module._modules.values():
        if child is not None:
            _addresses(child, out)


def _layout(t: Optional[torch.Tensor]):
    return None if t is None else (tuple(t.shape), t.dtype, t.device)


def forward_key(model: nn.Module, pixel_values: torch.Tensor,
                time: Optional[torch.Tensor]) -> tuple:
    """What a captured forward is bound to; a call whose key differs cannot
    replay it. In-place changes to the weights (``load_state_dict``, an
    optimizer step) keep it: a replay reads them."""
    addresses: list = []
    _addresses(model, addresses)
    return (model.training, torch.is_inference_mode_enabled(),
            _layout(pixel_values), _layout(time),
            torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            torch.is_autocast_enabled(), tuple(addresses))


class _ForwardGraph(Graph):
    """A model's graph, and the key of its previous eager call. Its capture
    lets other threads go on: the Trainer copies the next batch to the card
    on one while the model runs."""

    capture_error_mode = "thread_local"

    def __init__(self, device: torch.device):
        super().__init__(device, count_forward)
        self.seen = None


_GRAPHS: "weakref.WeakKeyDictionary[nn.Module, _ForwardGraph]" = weakref.WeakKeyDictionary()


def release(model: nn.Module) -> None:
    """Drop ``model``'s forward graph, if it has one, and with it the hold
    on its pool (after the replays still in flight)."""
    g = _GRAPHS.pop(model, None)
    if g is not None:
        g.drop()

Body = Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def graphed_forward(model: nn.Module, pixel_values: torch.Tensor,
                    time: Optional[torch.Tensor], body: Body) -> torch.Tensor:
    """``body(pixel_values, time)`` for a call :func:`eager_reason` admits:
    a replay, a capture, or an eager call (module docstring)."""
    key = forward_key(model, pixel_values, time)
    g = _GRAPHS.get(model)
    if g is None:
        g = _GRAPHS[model] = _ForwardGraph(pixel_values.device)
    inputs = {"pixel_values": pixel_values, "time": time}
    if key == g.key:
        g.seen = None
        with span("forward.replay"):
            g.replay(inputs)
        return g.out.clone()
    if key != g.seen:
        g.seen = key
        count_forward("eager.first")
        return g.eager(lambda: body(pixel_values, time))
    g.drop()
    g.seen = None
    try:
        g.capture(inputs, lambda s: body(s["pixel_values"], s["time"]))
    except BaseException:
        g.drop()
        raise
    g.key = key
    return g.out.clone()
