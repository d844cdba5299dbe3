"""The port's optimizer against the JAX package's optax one: the four
parameter groups (codes pushed through the linear weight bridge
``from_jax_params``), the LR schedules step by step, and five AdamW steps
with global-norm clipping active and inactive on the same synthetic
gradients (fp32, atol/rtol 1e-6)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from poseidon_tpu.training.optimizer import build_optimizer as j_build_optimizer
from poseidon_tpu.training.optimizer import label_params as j_label_params
from poseidon_tpu.training.optimizer import make_lr_schedule as j_make_lr_schedule

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.training import clip_by_global_norm, label_params, make_lr_schedule

from test_torch_model import CASES, build_pair, port_model

torch.set_num_threads(1)

CODES = {"decay": 0.0, "no_decay": 1.0, "embeddings": 2.0, "time_embedding": 3.0}
NAMES = {v: k for k, v in CODES.items()}


@pytest.mark.parametrize("use_emb,use_time", list(itertools.product([False, True], repeat=2)))
@pytest.mark.parametrize("case", ["conditioned", "unconditioned_resnet_no_qkv_bias"])
def test_label_params_match_jax(case, use_emb, use_time):
    jcfg, jvars, pcfg, sd = build_pair(**CASES[case])
    jlabels = j_label_params(jvars["params"], use_emb, use_time)
    codes = jax.tree.map(lambda p, lab: np.full(np.shape(p), CODES[lab], np.float32),
                         jvars["params"], jlabels)
    expected = {k: NAMES[float(v.flatten()[0])] for k, v in pt.from_jax_params(codes, pcfg).items()}
    model = port_model(pcfg, sd, "xla")
    ours = label_params(model, use_emb, use_time)
    assert ours == {k: v for k, v in expected.items() if k in ours}
    assert set(ours) == {n for n, _ in model.named_parameters()}
    assert set(ours.values()) >= {"decay", "no_decay"}


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant", "constant_with_warmup"])
@pytest.mark.parametrize("warmup_ratio", [0.0, 0.1])
def test_lr_schedule_matches_optax(kind, warmup_ratio):
    """Within 1e-6 of the peak LR: optax evaluates in fp32, the port in
    Python floats."""
    total, peak = 50, 3e-4
    ours = make_lr_schedule(kind, peak, total, warmup_ratio)
    ref = j_make_lr_schedule(kind, peak, total, warmup_ratio)
    for step in range(total + 10):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, atol=1e-6 * peak)


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_five_steps_match_optax(clip):
    jcfg, jvars, pcfg, sd = build_pair()
    params = jax.tree.map(jnp.asarray, jvars["params"])
    rng = np.random.default_rng(11)
    grads = [jax.tree.map(lambda p: (0.1 * (i + 1) * rng.normal(size=np.shape(p))).astype(np.float32),
                          jvars["params"]) for i in range(5)]
    norm0 = float(optax.global_norm(grads[0]))
    max_norm = 0.5 * norm0 if clip == "active" else 100.0 * norm0
    kw = dict(learning_rate=1e-3, total_steps=20, weight_decay=0.05, lr_scheduler_type="cosine",
              warmup_ratio=0.1, learning_rate_embedding_recovery=2e-3,
              learning_rate_time_embedding=5e-4)
    tx = j_build_optimizer(params, max_grad_norm=max_norm, **kw)
    state = tx.init(params)

    model = port_model(pcfg, sd, "xla")
    opt, sched = pt.build_optimizer(model, **kw)
    assert {g["label"] for g in opt.param_groups} == set(CODES)
    named = dict(model.named_parameters())
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        for name, tg in pt.from_jax_params(g, pcfg).items():
            named[name].grad = tg.clone()
        norm = clip_by_global_norm(model.parameters(), max_norm)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        opt.step()
        sched.step()
        opt.zero_grad(set_to_none=True)
        ref = pt.from_jax_params(jax.tree.map(np.asarray, params), pcfg)
        for name, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=1e-6, rtol=1e-6,
                                       err_msg=name)


def test_clip_rule_is_optax_not_clip_grad_norm():
    """Scaled by max_norm / norm exactly (clip_grad_norm_ adds 1e-6 to the
    norm), and left alone below the threshold."""
    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.tensor([3.0, 4.0, 0.0, 0.0])
    assert float(clip_by_global_norm([p], 1.0)) == 5.0
    assert torch.equal(p.grad, torch.tensor([3.0, 4.0, 0.0, 0.0]) / 5.0)
    p.grad = torch.tensor([0.3, 0.4, 0.0, 0.0])
    clip_by_global_norm([p], 1.0)
    assert torch.equal(p.grad, torch.tensor([0.3, 0.4, 0.0, 0.0]))
