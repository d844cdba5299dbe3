"""What of ``train_step``'s CUDA graph (``training/step_graph.py``) the CPU
can check, on a toy ScOT: the rule that decides which calls are captured
and the reason each other call gives, as ``tracing.graph_counts`` records
them; the step key, which changes exactly where a captured step could no
longer be replayed; ``LambdaLR`` over the device-tensor LRs that
``make_capturable`` gives the groups; and a CPU ``train_step``, eager and
unchanged. The capture and replays themselves run on the card
(``test_torch_step_graph_cuda.py``)."""

import copy

import numpy as np
import pytest
import torch

import poseidon_tpu_torch as pt
from poseidon_tpu_torch import tracing
from poseidon_tpu_torch.models.scot import forward_with_loss
from poseidon_tpu_torch.training import step_graph
from poseidon_tpu_torch.training.optimizer import clip_by_global_norm

torch.set_num_threads(1)

TOY = dict(image_size=32, patch_size=4, num_channels=2, num_out_channels=2, embed_dim=24,
           depths=(1, 1), num_heads=(2, 2), skip_connections=(1, 0), window_size=4,
           channel_slice_list=(0, 1, 2), use_conditioning=True, attention_impl="xla")


def _setup(seed=0, drop_path_rate=0.0, **kw):
    model = pt.build_model(pt.make_config("T", **TOY, drop_path_rate=drop_path_rate),
                           device="cpu", seed=seed)
    opt, sched = pt.build_optimizer(model, learning_rate=1e-3, total_steps=6,
                                    weight_decay=1e-6, lr_scheduler_type="cosine",
                                    warmup_ratio=0.0, **kw)
    return model, opt, sched


def _batch(seed=0, n=2, size=32):
    rng = np.random.default_rng(seed)
    x, y = (torch.from_numpy(rng.normal(size=(n, 2, size, size)).astype(np.float32))
            for _ in range(2))
    t = torch.from_numpy(rng.uniform(0.1, 1.0, size=n).astype(np.float32))
    return {"pixel_values": x, "labels": y, "time": t}


def _delta(before, after):
    out = {k: after[k] - before[k] for k in ("captures", "replays") if after[k] != before[k]}
    out.update({"eager." + r: after["eager"][r] - before["eager"][r] for r in after["eager"]
                if after["eager"][r] != before["eager"][r]})
    return out


def test_graph_counts_name_every_reason():
    counts = tracing.graph_counts()
    assert set(counts) == {"captures", "replays", "eager"}
    assert tuple(counts["eager"]) == tracing.EAGER_REASONS
    assert set(tracing.EAGER_REASONS) >= {"cpu", "group", "loss_fn", "generator", "capturing",
                                          "masks"}


def test_cpu_step_is_eager_and_unchanged():
    model, opt, sched = _setup()
    ref_model, ref_opt, ref_sched = _setup()
    batches = [_batch(s) for s in range(3)]
    before = tracing.graph_counts()
    for b in batches:
        out = pt.train_step(model, opt, sched, b, max_grad_norm=0.5)
        # What train_step did before it had a graph, written out.
        ref_model.train()
        loss = forward_with_loss(ref_model, b["pixel_values"], b["time"], b["labels"], None)[0]
        loss.backward()
        norm = clip_by_global_norm([p for p in ref_model.parameters() if p.requires_grad], 0.5)
        ref_opt.step()
        ref_sched.step()
        ref_opt.zero_grad(set_to_none=True)
        assert torch.equal(out["loss"], loss.detach())
        assert torch.equal(out["grad_norm"], norm)
    assert _delta(before, tracing.graph_counts()) == {"eager.cpu": 3}
    for p, q in zip(model.parameters(), ref_model.parameters()):
        assert torch.equal(p, q)
        assert p.grad is None
    assert not opt.defaults.get("capturable")
    assert all(isinstance(g["lr"], float) for g in opt.param_groups)
    assert opt not in step_graph._GRAPHS


def _dist_group():
    return object()   # only compared with None before the CUDA check


@pytest.mark.parametrize("reason", ["cpu", "group", "loss_fn", "generator", "masks",
                                    "capturing", "optimizer", "grads"])
def test_eager_reason_takes_the_first_condition_a_call_fails(reason, monkeypatch):
    model, opt, _ = _setup(drop_path_rate=0.1 if reason == "masks" else 0.0)
    batch = _batch()
    on_cuda = reason != "cpu"
    monkeypatch.setattr(step_graph, "on_cuda", lambda m, b: on_cuda)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: reason == "capturing")
    kw = dict(group=None, loss_fn=None, generator=None)
    if reason == "group":
        kw["group"] = _dist_group()
    if reason == "loss_fn":
        kw["loss_fn"] = lambda m, b: None
    if reason == "generator":
        kw["generator"] = torch.Generator()
    if reason == "optimizer":
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
    if reason == "grads":
        next(model.parameters()).grad = torch.zeros_like(next(model.parameters()))
    assert step_graph.eager_reason(model, opt, batch, **kw) == reason
    # Every earlier condition holding too does not change the answer.
    kw = dict(group=_dist_group(), loss_fn=lambda m, b: None, generator=torch.Generator())
    order = ["group", "loss_fn", "generator"]
    if reason in order:
        kw.update({k: None for k in order[:order.index(reason)]})
        assert step_graph.eager_reason(model, opt, batch, **kw) == reason


def test_an_admitted_call_has_no_reason(monkeypatch):
    model, opt, _ = _setup()
    monkeypatch.setattr(step_graph, "on_cuda", lambda m, b: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert step_graph.eager_reason(model, opt, _batch(), group=None, loss_fn=None,
                                   generator=None) is None


@pytest.mark.parametrize("kw,reason", [
    ({"loss_fn": lambda m, b: forward_with_loss(m, b["pixel_values"], b["time"], b["labels"],
                                                None)[0]}, "loss_fn"),
    ({"generator": torch.Generator()}, "generator"),
    ({}, "masks"),
    ({}, "capturing"),
])
def test_train_step_counts_its_eager_reason(kw, reason, monkeypatch):
    # As though on the card: the call still steps eagerly (on the CPU) and
    # the counter gets its reason, not "cpu".
    rate = 0.1 if reason == "masks" else 0.0
    model, opt, sched = _setup(drop_path_rate=rate)
    ref_model, ref_opt, ref_sched = _setup(drop_path_rate=rate)
    if rate:
        torch.manual_seed(0)
    monkeypatch.setattr(step_graph, "on_cuda", lambda m, b: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: reason == "capturing")
    before = tracing.graph_counts()
    out = pt.train_step(model, opt, sched, _batch(), max_grad_norm=0.5, **kw)
    assert _delta(before, tracing.graph_counts()) == {"eager." + reason: 1}
    monkeypatch.undo()
    if rate:
        torch.manual_seed(0)
    ref = pt.train_step(ref_model, ref_opt, ref_sched, _batch(), max_grad_norm=0.5)
    assert torch.equal(out["loss"], ref["loss"])
    assert opt not in step_graph._GRAPHS


def _key(model, opt, batch, clip=5.0):
    return step_graph.step_key(model, opt, batch, clip)


def _device_lrs(opt):
    """The groups' LRs as tensors, as a captured step has them, with AdamW's
    default arithmetic (its capturable mode needs a card)."""
    step_graph.make_capturable(opt, torch.device("cpu"))
    for g in opt.param_groups:
        g["capturable"] = False


def test_step_key_holds_across_steps_and_batches_of_one_shape():
    model, opt, sched = _setup()
    _device_lrs(opt)
    pt.train_step(model, opt, sched, _batch(0), max_grad_norm=5.0)   # AdamW's state exists
    key = _key(model, opt, _batch(0))
    pt.train_step(model, opt, sched, _batch(1), max_grad_norm=5.0)
    assert _key(model, opt, _batch(1)) == key
    assert _key(model, opt, dict(reversed(list(_batch(2).items())))) == key
    model.load_state_dict(copy.deepcopy(model.state_dict()))   # copied in place
    assert _key(model, opt, _batch(0)) == key


def _changes():
    """(name, change) pairs: each takes (model, opt, batch) and returns the
    arguments of a key that must differ from the unchanged one."""
    def batch_shape(m, o, b):
        return m, o, _batch(n=3), 5.0

    def batch_dtype(m, o, b):
        return m, o, {**b, "time": b["time"].double()}, 5.0

    def batch_key(m, o, b):
        return m, o, {**b, "pixel_mask": torch.ones(2, 2, dtype=torch.bool)}, 5.0

    def clip(m, o, b):
        return m, o, b, 1.0

    def eval_mode(m, o, b):
        return m.eval(), o, b, 5.0

    def new_parameter(m, o, b):
        p = next(m.parameters())
        p.data = p.data.clone()
        return m, o, b, 5.0

    def new_buffer(m, o, b):
        name, buf = next((n, t) for mod in m.modules() for n, t in mod._buffers.items()
                         if t is not None)
        mod = next(mod for mod in m.modules() if mod._buffers.get(name) is buf)
        mod._buffers[name] = buf.clone()
        return m, o, b, 5.0

    def loaded_state(m, o, b):
        o.load_state_dict(copy.deepcopy(o.state_dict()))
        return m, o, b, 5.0

    def new_lr_tensor(m, o, b):
        o.param_groups[0]["lr"] = o.param_groups[0]["lr"].clone()
        return m, o, b, 5.0

    def group_setting(m, o, b):
        o.param_groups[0]["weight_decay"] = 0.5
        return m, o, b, 5.0

    def new_model(m, o, b):
        return _setup()[0], o, b, 5.0

    def new_optimizer(m, o, b):
        return m, _setup()[1], b, 5.0

    return [(f.__name__, f) for f in (batch_shape, batch_dtype, batch_key, clip, eval_mode,
                                      new_parameter, new_buffer, loaded_state, new_lr_tensor,
                                      group_setting, new_model, new_optimizer)]


@pytest.mark.parametrize("name,change", _changes())
def test_step_key_changes_where_a_capture_goes_stale(name, change):
    model, opt, sched = _setup()
    _device_lrs(opt)
    pt.train_step(model, opt, sched, _batch(0), max_grad_norm=5.0)
    model.train()
    batch = _batch(1)
    key = _key(model, opt, batch)
    assert step_graph.step_key(*change(model, opt, batch)) != key


def test_make_capturable_gives_device_lrs_once():
    model, opt, sched = _setup(learning_rate_time_embedding=3e-4)
    step_graph.make_capturable(opt, torch.device("cpu"))
    lrs = [g["lr"] for g in opt.param_groups]
    assert all(torch.is_tensor(lr) and lr.dtype == torch.float32 and lr.dim() == 0 for lr in lrs)
    assert opt.defaults["capturable"] and all(g["capturable"] for g in opt.param_groups)
    assert [float(lr) for lr in lrs] == pytest.approx([1e-3, 1e-3, 3e-4], rel=1e-6)
    step_graph.make_capturable(opt, torch.device("cpu"))
    assert all(g["lr"] is lr for g, lr in zip(opt.param_groups, lrs))


def test_lambda_lr_fills_device_lrs_with_the_schedule():
    # What a replayed step reads: the LR LambdaLR writes into each group's
    # tensor with fill_ (a cosine over 6 steps, then held at 0), the tensors
    # kept, base_lrs still floats.
    _, opt, sched = _setup(learning_rate_time_embedding=3e-4)
    _, ref_opt, ref_sched = _setup(learning_rate_time_embedding=3e-4)
    step_graph.make_capturable(opt, torch.device("cpu"))
    tensors = [g["lr"] for g in opt.param_groups]
    seen = []
    for _ in range(8):
        assert all(g["lr"] is t for g, t in zip(opt.param_groups, tensors))
        lrs = [float(t) for t in tensors]
        assert lrs == pytest.approx([g["lr"] for g in ref_opt.param_groups], rel=1e-6, abs=1e-12)
        seen.append(lrs)
        for o, s in ((opt, sched), (ref_opt, ref_sched)):
            o.step()   # no gradients: nothing to update
            s.step()
    assert all(isinstance(b, float) for b in sched.base_lrs)
    assert len({tuple(v) for v in seen}) == 7 and seen[6] == seen[7] == [0.0] * 3
