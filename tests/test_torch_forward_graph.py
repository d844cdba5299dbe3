"""What of ScOT's forward graph (``poseidon_tpu_torch/models/forward_graph.py``)
the CPU can check, on a toy ScOT: the rule that decides which calls are
captured and the reason each other call gives, as
``tracing.forward_graph_counts`` records them; that such calls run the eager
body bit for bit; the forward key, which changes exactly where a captured
forward could no longer be replayed; and the policy (first call eager, the
second in a row captures, later ones replay, another key runs eagerly and
leaves the graph) on a stand-in for the CUDA graph that runs the captured
function again at each replay. The capture and replays themselves run on
the card (``test_torch_forward_graph_cuda.py``)."""

import contextlib
import copy
import gc

import numpy as np
import pytest
import torch

import poseidon_tpu_torch as pt
from poseidon_tpu_torch import tracing
from poseidon_tpu_torch.models import forward_graph
from poseidon_tpu_torch.models.scot import ScOT, init_weights

torch.set_num_threads(1)

TOY = dict(image_size=32, patch_size=4, num_channels=2, num_out_channels=2, embed_dim=24,
           depths=(1, 1), num_heads=(2, 2), skip_connections=(1, 0), window_size=4,
           channel_slice_list=(0, 1, 2), use_conditioning=True, attention_impl="xla")


def _model(seed=0, use_mask_token=False, **kw):
    model = ScOT(pt.make_config("T", **{**TOY, **kw}), use_mask_token=use_mask_token)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval()


def _inputs(seed=0, n=2, size=32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, 2, size, size)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0.1, 1.0, size=n).astype(np.float32))
    return x, t


def _delta(before, after):
    out = {k: after[k] - before[k] for k in ("captures", "replays") if after[k] != before[k]}
    out.update({r: after["eager"][r] - before["eager"][r] for r in after["eager"]
                if after["eager"][r] != before["eager"][r]})
    return out


def _as_on_card(monkeypatch, capturing=False):
    monkeypatch.setattr(forward_graph, "on_cuda", lambda m, *t: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)


def test_forward_graph_counts_name_every_reason_in_order():
    counts = tracing.forward_graph_counts()
    assert set(counts) == {"captures", "replays", "eager"}
    assert tuple(counts["eager"]) == tracing.FORWARD_EAGER_REASONS
    assert tracing.FORWARD_EAGER_REASONS == (
        "cpu", "grad", "masks", "capturing", "masked", "resized", "intermediates",
        "collective", "first")
    # The train step's counter is its own.
    assert tuple(tracing.graph_counts()["eager"]) == tracing.EAGER_REASONS


def _call(reason, monkeypatch):
    """A model and a call that fails exactly ``reason`` (and every condition
    before it holds), as though on the card except for ``cpu``; returns
    (model, call, (x, t, mask)), where ``call(m)`` runs ``m``'s forward as
    tested."""
    kw = {"drop_path_rate": 0.1} if reason == "masks" else {}
    model = _model(use_mask_token=reason == "masked", **kw)
    if reason != "cpu":
        _as_on_card(monkeypatch, capturing=reason == "capturing")
    x, t = _inputs(size=16 if reason == "resized" else 32)
    mask = torch.zeros(2, 64, dtype=torch.bool) if reason == "masked" else None
    if reason == "masked":
        mask[:, ::3] = True
    if reason == "masks":
        model.train()

    def call(m):
        if reason == "masks":
            torch.manual_seed(0)   # drop-path draws on the host
        with torch.set_grad_enabled(reason == "grad"):
            if reason == "intermediates":
                return pt.forward_with_intermediates(m, x, t)[0]
            return m(x, t, bool_masked_pos=mask)
    return model, call, (x, t, mask)


@pytest.mark.parametrize("reason", tracing.FORWARD_EAGER_REASONS[:-2])
def test_ineligible_calls_run_the_eager_body_and_count_their_reason(reason, monkeypatch):
    model, call, (x, t, mask) = _call(reason, monkeypatch)
    if reason != "intermediates":
        with torch.set_grad_enabled(reason == "grad"):
            assert forward_graph.eager_reason(model, x, t, mask) == reason
    before = tracing.forward_graph_counts()
    out = call(model)
    assert _delta(before, tracing.forward_graph_counts()) == {reason: 1}
    assert model not in forward_graph._GRAPHS
    if reason == "masks":
        torch.manual_seed(0)
    with torch.set_grad_enabled(reason == "grad"):
        want = model.eager_forward(x, t, bool_masked_pos=mask)
    assert torch.equal(out, want)


def test_collective_calls_run_eagerly(monkeypatch, tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    _as_on_card(monkeypatch)
    x, t = _inputs()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        # In train mode (zero rates) a BatchNorm with a group all-reduces.
        model = _model(residual_model="resnet").train()
        with torch.no_grad():
            assert forward_graph.eager_reason(model, x, t, None) is None
            bn = next(m for m in model.modules() if hasattr(m, "process_group"))
            bn.process_group = dist.group.WORLD
            assert forward_graph.eager_reason(model, x, t, None) == "collective"
            assert forward_graph.eager_reason(model.eval(), x, t, None) is None

        model = _model()
        ref = copy.deepcopy(model)
        fully_shard(model, mesh=init_device_mesh("cpu", (1,)))
        with torch.no_grad():
            assert forward_graph.eager_reason(model, x, t, None) == "collective"
        before = tracing.forward_graph_counts()
        with torch.no_grad():
            out = model(x, t)
        assert _delta(before, tracing.forward_graph_counts()) == {"collective": 1}
        with torch.no_grad():
            assert torch.equal(out, ref.eager_forward(x, t))
    finally:
        dist.destroy_process_group()


def test_an_admitted_call_has_no_reason(monkeypatch):
    _as_on_card(monkeypatch)
    x, t = _inputs()
    model = _model()
    with torch.no_grad():
        assert forward_graph.eager_reason(model, x, t, None) is None
        assert forward_graph.eager_reason(model, x, None, None) is None
        # In eval mode a model with rates draws nothing; in train mode at
        # zero rates neither.
        assert forward_graph.eager_reason(_model(drop_path_rate=0.1), x, t, None) is None
        assert forward_graph.eager_reason(model.train(), x, t, None) is None
    with torch.inference_mode():
        assert forward_graph.eager_reason(model, x, t, None) is None


def test_forward_key_holds_across_inputs_and_in_place_updates():
    model = _model()
    x, t = _inputs(0)
    key = forward_graph.forward_key(model, x, t)
    assert forward_graph.forward_key(model, *_inputs(1)) == key
    # Strides are not in the key: the forward's result does not depend on
    # them (a rollout feeds back the forward's NHWC-strided output).
    nhwc = x.contiguous(memory_format=torch.channels_last)
    assert forward_graph.forward_key(model, nhwc, torch.stack([t, t], 1)[:, 0]) == key
    with torch.no_grad():
        fed = model.eager_forward(x, t)
        assert not fed.is_contiguous()
        assert torch.equal(model.eager_forward(fed, t), model.eager_forward(fed.contiguous(), t))
        assert torch.equal(model.eager_forward(nhwc, t), model.eager_forward(x, t))
    model.load_state_dict(copy.deepcopy(model.state_dict()))   # copied in place
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    assert forward_graph.forward_key(model, x, t) == key


def _changes():
    """(name, change): each takes (model, x, t) and returns the arguments
    of a key that must differ from the unchanged one."""
    def batch_shape(m, x, t):
        return m, *_inputs(n=3)

    def input_dtype(m, x, t):
        return m, x.double(), t

    def time_none(m, x, t):
        return m, x, None

    def time_dtype(m, x, t):
        return m, x, t.double()

    def train_mode(m, x, t):
        return m.train(), x, t

    def new_parameter(m, x, t):
        p = next(m.parameters())
        p.data = p.data.clone()
        return m, x, t

    def new_buffer(m, x, t):
        mod, name = next((mod, n) for mod in m.modules() for n, b in mod._buffers.items()
                         if b is not None)
        mod._buffers[name] = mod._buffers[name].clone()
        return m, x, t

    def moved(m, x, t):
        return m.to(torch.float64).to(torch.float32), x, t

    def replaced_module(m, x, t):
        m.patch_recovery = copy.deepcopy(m.patch_recovery)
        return m, x, t

    def matmul_precision(m, x, t):
        torch.set_float32_matmul_precision("high")
        return m, x, t

    return [(f.__name__, f) for f in (batch_shape, input_dtype, time_none,
                                      time_dtype, train_mode, new_parameter, new_buffer, moved,
                                      replaced_module, matmul_precision)]


@pytest.mark.parametrize("name,change", _changes())
def test_forward_key_changes_where_a_capture_goes_stale(name, change):
    precision = torch.get_float32_matmul_precision()
    try:
        model = _model()
        x, t = _inputs()
        key = forward_graph.forward_key(model, x, t)
        assert forward_graph.forward_key(*change(model, x, t)) != key
    finally:
        torch.set_float32_matmul_precision(precision)


def test_forward_key_changes_with_inference_mode():
    model = _model()
    x, t = _inputs()
    with torch.no_grad():
        key = forward_graph.forward_key(model, x, t)
    with torch.inference_mode():
        assert forward_graph.forward_key(model, x, t) != key


class _StandIn:
    """A CUDA graph's stand-in: the capture keeps the function and static
    copies of the inputs, a replay copies the inputs in and runs the
    function again on them into the same output tensor."""

    def __init__(self, device):
        self.key = self.graph = self.out = self.fn = None
        self.static = {}
        self.seen = None
        self.dropped = 0

    def eager(self, fn):
        return fn()

    def capture(self, inputs, fn):
        self.static = {k: None if v is None else v.clone() for k, v in inputs.items()}
        self.fn, self.graph = fn, "captured"
        self.out = fn(self.static)
        tracing.count_forward("captures")
        tracing.count_forward("replays")

    def replay(self, inputs):
        for k, v in inputs.items():
            if v is not None:
                self.static[k].copy_(v)
        self.out.copy_(self.fn(self.static))
        tracing.count_forward("replays")

    def drop(self):
        self.dropped += self.graph is not None
        self.key = self.graph = self.out = self.fn = None


def test_policy_captures_the_second_call_in_a_row_and_keeps_the_main_shape(monkeypatch):
    _as_on_card(monkeypatch)
    monkeypatch.setattr(forward_graph, "_ForwardGraph", _StandIn)
    model, ref = _model(), _model()
    main = [_inputs(s) for s in range(4)]
    odd = _inputs(9, n=3)
    calls = [main[0], main[1], main[2], odd, main[3], odd, odd, main[0], odd]
    before = tracing.forward_graph_counts()
    outs = []
    with torch.no_grad():
        for i, (x, t) in enumerate(calls):
            out = model(x, t)
            assert torch.equal(out, ref.eager_forward(x, t)), i
            outs.append(out)
        g = forward_graph._GRAPHS[model]
        # first, capture, replay, odd first, replay, odd first, odd captures
        # (the main graph dropped), main first, odd replays.
        assert _delta(before, tracing.forward_graph_counts()) == {
            "first": 4, "captures": 2, "replays": 5}
        assert g.dropped == 1 and g.key == forward_graph.forward_key(model, *odd)
    # Every call's output is its own tensor, not the static output.
    assert len({o.data_ptr() for o in outs}) == len(outs)
    assert all(o.data_ptr() != g.out.data_ptr() for o in outs)


def test_policy_reads_in_place_weight_updates_and_new_tensors(monkeypatch):
    _as_on_card(monkeypatch)
    monkeypatch.setattr(forward_graph, "_ForwardGraph", _StandIn)
    model, ref = _model(), _model()
    x, t = _inputs()
    before = tracing.forward_graph_counts()
    with torch.no_grad():
        model(x, t)
        model(x, t)
        other = _model(seed=1).state_dict()
        model.load_state_dict(other)
        ref.load_state_dict(other)
        assert torch.equal(model(x, t), ref.eager_forward(x, t))   # a replay
        model.to(torch.float64).to(torch.float32)   # new tensors: a new key
        assert torch.equal(model(x, t), ref.eager_forward(x, t))
    assert _delta(before, tracing.forward_graph_counts()) == {
        "first": 2, "captures": 1, "replays": 2}


def test_a_change_of_mode_releases_the_graph(monkeypatch):
    _as_on_card(monkeypatch)
    monkeypatch.setattr(forward_graph, "_ForwardGraph", _StandIn)
    model, ref = _model(), _model()
    x, t = _inputs()
    before = tracing.forward_graph_counts()
    with torch.no_grad():
        for _ in range(3):
            model(x, t)
        g = forward_graph._GRAPHS[model]
        model.eval()   # no change of mode: the graph stays
        assert forward_graph._GRAPHS[model] is g and g.graph is not None
        assert model.train() is model
        assert model not in forward_graph._GRAPHS and g.dropped == 1 and g.graph is None
        model.train()
        model.eval()   # nothing left to release
        for _ in range(3):
            assert torch.equal(model(x, t), ref.eager_forward(x, t))
    assert _delta(before, tracing.forward_graph_counts()) == {
        "first": 2, "captures": 2, "replays": 4}
    # Releasing a model that never had a graph, or a CPU model, is a no-op.
    forward_graph.release(ref)
    assert ref.train().training and not ref.eval().training


class _FakeCUDAGraph:
    def replay(self):
        pass


@contextlib.contextmanager
def _fake_capture(graph, stream=None, capture_error_mode=None):
    yield


def test_a_capture_holds_the_collector_and_a_failed_one_retires_its_stream(monkeypatch):
    stream = object()
    monkeypatch.setattr(forward_graph, "_STREAMS", {0: stream})
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    counts = []
    g = forward_graph.Graph(torch.device("cuda", 0), counts.append)
    assert g.stream is stream
    collecting = []

    def double(static):
        collecting.append(gc.isenabled())
        return static["x"] * 2

    def fails(static):
        collecting.append(gc.isenabled())
        raise RuntimeError("operation failed due to a previous error during capture")

    x = torch.arange(3.0)
    assert gc.isenabled()
    g.capture({"x": x, "t": None}, double)
    assert collecting == [False] and gc.isenabled()
    assert counts == ["captures", "replays"] and torch.equal(g.out, 2 * x)
    gc.disable()
    try:
        g.capture({"x": x}, double)   # a collector the caller holds stays held
        assert not gc.isenabled()
    finally:
        gc.enable()
    with pytest.raises(RuntimeError):
        g.capture({"x": x}, fails)
    assert collecting == [False, False, False] and gc.isenabled()
    assert forward_graph._STREAMS == {}
