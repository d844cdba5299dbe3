"""The port's spans (``poseidon_tpu_torch/tracing.py``) on the CPU, on a toy
ScOT: under ``torch.profiler.profile`` a ``train_step`` carries
``scot.train_step`` with its three phases inside, and the Swin block's parts
inside ``scot.forward``; a rollout carries ``scot.rollout`` with the block
parts; the port opens no other ``scot.*`` range; the profiler changes no
bit of the loss, the gradients or the rollout; a backward op's sequence
number finds its forward op inside ``scot.block.mlp``. Without a profiler
``span`` returns one shared no-op context."""

import json

import numpy as np
import pytest
import torch

import poseidon_tpu_torch as pt
from poseidon_tpu_torch import tracing

torch.set_num_threads(1)

# Stage 0 has 16 x 16 tokens an image, so that the fused tail's gate takes
# it under "pallas" with fused_block_tail.
TOY = dict(image_size=64, patch_size=4, num_channels=2, num_out_channels=2, embed_dim=24,
           depths=(2, 2), num_heads=(2, 2), skip_connections=(1, 0), window_size=4,
           channel_slice_list=(0, 1, 2), use_conditioning=True)
PATHS = {"plain": dict(attention_impl="xla"),
         "kernels": dict(attention_impl="pallas"),
         "fused_tail": dict(attention_impl="pallas", fused_block_tail=True)}
BLOCKS = 2 * sum(TOY["depths"])
EIGHT = {"scot.train_step", "scot.forward", "scot.backward", "scot.optimizer", "scot.rollout",
         "scot.block.attention", "scot.block.norm", "scot.block.mlp"}


def _model(path):
    return pt.build_model(pt.make_config("T", **TOY, **PATHS[path]), device="cpu", seed=0)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x, y = (torch.from_numpy(rng.normal(size=(2, 2, 64, 64)).astype(np.float32))
            for _ in range(2))
    t = torch.from_numpy(rng.uniform(0.1, 1.0, size=2).astype(np.float32))
    return {"pixel_values": x, "labels": y, "time": t}


def _step(model, profiled, tmp_path=None):
    """One train_step: (loss, grad norm, the gradients the optimizer saw,
    the Chrome trace's events or None)."""
    opt, sched = pt.build_optimizer(model, learning_rate=1e-3, total_steps=10,
                                    weight_decay=1e-6, lr_scheduler_type="cosine",
                                    warmup_ratio=0.0)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}))
    if not profiled:
        return pt.train_step(model, opt, sched, _batch(), max_grad_norm=1.0), grads, None
    with torch.profiler.profile() as prof:
        out = pt.train_step(model, opt, sched, _batch(), max_grad_norm=1.0)
    return out, grads, _events(prof, tmp_path)


def _rollout(model, profiled, tmp_path=None):
    b = _batch(1)
    model.eval()
    run = lambda: pt.autoregressive_rollout(  # noqa: E731
        model, b["pixel_values"], b["time"], 3, 2, output_all_steps=True, device="cpu")
    if not profiled:
        return run(), None
    with torch.profiler.profile() as prof:
        out = run()
    return out, _events(prof, tmp_path)


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _spans(events, prefix="scot."):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith(prefix)]


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def test_span_is_one_shared_no_op_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    a, b = tracing.span("block.mlp"), tracing.span("train_step")
    assert a is b
    with a:
        pass
    with torch.profiler.profile():
        on = tracing.span("block.mlp")
        assert on is not a
        with on:
            pass
    assert tracing.span("block.mlp") is a


@pytest.mark.parametrize("path", sorted(PATHS))
def test_train_step_spans_nest(path, tmp_path):
    _, _, events = _step(_model(path), True, tmp_path)
    spans = _spans(events)
    [step] = _named(spans, "scot.train_step")
    phases = [_named(spans, "scot." + p) for p in ("forward", "backward", "optimizer")]
    assert all(len(p) == 1 and _inside(p[0], step) for p in phases)
    (fwd,), (bwd,), (opt,) = phases
    assert fwd["ts"] + fwd["dur"] <= bwd["ts"] and bwd["ts"] + bwd["dur"] <= opt["ts"]
    fused = path == "fused_tail"
    counts = {"attention": BLOCKS, "mlp": BLOCKS,
              "norm": BLOCKS + (BLOCKS - 2 * TOY["depths"][0] if fused else BLOCKS)}
    for part, n in counts.items():
        found = _named(spans, "scot.block." + part)
        assert len(found) == n, part
        assert all(_inside(s, fwd) for s in found), part
    assert {s["name"] for s in spans} == EIGHT - {"scot.rollout"}


def test_rollout_spans(tmp_path):
    _, events = _rollout(_model("kernels"), True, tmp_path)
    spans = _spans(events)
    [roll] = _named(spans, "scot.rollout")
    parts = _spans(events, "scot.block.")
    assert len(parts) == 3 * BLOCKS * 4          # 3 steps; attention, two norms, MLP
    assert all(_inside(s, roll) for s in parts)
    assert {s["name"] for s in spans} == {"scot.rollout", "scot.block.attention",
                                          "scot.block.norm", "scot.block.mlp"}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_profiler_changes_no_bit(path, tmp_path):
    out0, grads0, _ = _step(_model(path), False)
    out1, grads1, _ = _step(_model(path), True, tmp_path)
    assert torch.equal(out0["loss"], out1["loss"])
    assert torch.equal(out0["grad_norm"], out1["grad_norm"])
    assert grads0.keys() == grads1.keys() and len(grads0) > 50
    for k in grads0:
        assert torch.equal(grads0[k], grads1[k]), k
    roll0, _ = _rollout(_model(path), False)
    roll1, _ = _rollout(_model(path), True, tmp_path)
    assert torch.equal(roll0, roll1)


def test_backward_op_finds_its_forward_op_in_the_mlp_span(tmp_path):
    _, _, events = _step(_model("plain"), True, tmp_path)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    mlp = _named(_spans(events), "scot.block.mlp")
    # Forward ops carry a forward thread id of 0, backward ops the id of the
    # thread that ran their forward op.
    forward = {e["args"]["Sequence number"]: e for e in ops
               if "Sequence number" in e["args"] and not e["args"].get("Fwd thread id")}
    backward = [e for e in ops if e["args"].get("Fwd thread id")
                and e["name"] == "autograd::engine::evaluate_function: MmBackward0"]
    assert backward
    found = [forward.get(e["args"]["Sequence number"]) for e in backward]
    assert all(f is not None for f in found)
    in_mlp = [f for f in found if any(_inside(f, s) for s in mlp)]
    # Each block MLP runs two products; the rest are attention projections,
    # embeddings, merging and recovery.
    assert len(in_mlp) == 2 * BLOCKS
    assert all(f["name"] in ("aten::mm", "aten::addmm") for f in in_mlp)
