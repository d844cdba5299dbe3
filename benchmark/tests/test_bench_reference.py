"""The frozen reference against the port's plain path at a toy geometry:
weight names and shapes, the forward, the gradients of the loss, and
AdamW steps with and without clipping."""

import json

import pytest
import torch

import poseidon_tpu_torch as pt
from benchmark import harness, inputs
from benchmark.reference import train as ref_train
from benchmark.reference.scot import Reference, param_shapes
from benchmark.tests.toy import REPO, TOY_MODEL

CONFIG = json.loads((REPO / "benchmark/configs/scot_b.json").read_text())
CONFIG["model"].update(TOY_MODEL)
MODEL = CONFIG["model"]
OPT = {"learning_rate": 1e-4, "total_steps": 10000, "weight_decay": 1e-6,
       "betas": [0.9, 0.999], "eps": 1e-8}


def plain_model(weights):
    prog = dict(CONFIG["program"], attention_impl="xla", score_dtype="float32")
    model = pt.ScOT(harness.program_config(pt, dict(CONFIG, program=prog)), dtype=torch.float32)
    model.load_state_dict(weights)
    return model


def batch(seed, n=3):
    traffic = {"loop": "train", "batch": n, "lead_time": 0.5, "masked_channels": [3]}
    return inputs.make_batch(MODEL, traffic, seed, 0, "cpu")


def rel(a, b):
    return float((a - b).norm() / b.norm())


def test_names_and_shapes_are_the_ports():
    w = inputs.make_weights(MODEL, 1, "cpu", 0.02)
    model = plain_model(w)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == dict(param_shapes(MODEL))


def test_forward_matches_the_plain_path():
    w = inputs.make_weights(MODEL, 2, "cpu", 0.02)
    b = batch(3)
    with torch.no_grad():
        want = plain_model(w).eval()(b["pixel_values"], b["time"])
        got = Reference(MODEL).forward(w, b["pixel_values"], b["time"])
    assert rel(got, want) < 1e-5


def test_gradients_match_the_plain_path():
    w = inputs.make_weights(MODEL, 4, "cpu", 0.02)
    b = batch(5, n=4)
    model = plain_model(w).train()
    loss, _ = pt.forward_with_loss(model, b["pixel_values"], b["time"], b["labels"],
                                   b["pixel_mask"])
    loss.backward()
    params = {k: v.clone() for k, v in w.items()}
    ref_loss, grads = ref_train.loss_and_grads(Reference(MODEL), params, b, rows=3)
    assert abs(float(ref_loss) - float(loss.detach())) < 1e-6 * abs(float(loss.detach()))
    for name, p in model.named_parameters():
        # A stage whose window is one token passes no gradient to its logit scale.
        assert float((grads[name] - p.grad).norm()) <= 1e-4 * float(p.grad.norm()) + 1e-12, name


@pytest.mark.parametrize("max_grad_norm", [5.0, 1e-3])
def test_adamw_steps_match_the_ports(max_grad_norm):
    w = inputs.make_weights(MODEL, 6, "cpu", 0.02)
    batches = [batch(7 + i) for i in range(2)]
    model = plain_model(w).train()
    opt, sched = pt.build_optimizer(model, learning_rate=OPT["learning_rate"],
                                    total_steps=OPT["total_steps"],
                                    weight_decay=OPT["weight_decay"], warmup_ratio=0.0)
    norms = [float(pt.train_step(model, opt, sched, b, max_grad_norm=max_grad_norm)["grad_norm"])
             for b in batches]
    params = {k: v.clone() for k, v in w.items()}
    out = ref_train.train_steps(Reference(MODEL), params, batches, OPT, max_grad_norm, rows=2)
    assert out["grad_norms"] == pytest.approx(norms, rel=1e-5)
    for name, p in model.named_parameters():
        moved = params[name] - w[name]
        assert float((p.detach() - params[name]).norm()) <= 1e-3 * float(moved.norm()) + 1e-9, name
