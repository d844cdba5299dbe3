"""The port's whole-model gradients and train step against the JAX package,
on the CPU at toy sizes, fp32, for both ``attention_impl`` values (under
"pallas" the JAX side runs its Pallas kernels in interpret mode and the
port its kernels' autograd Functions with the plain versions).

- Gradients: the pixel-masked grouped L1 loss of the model in train mode
  (BatchNorm on batch statistics) through ``jax.value_and_grad`` and through
  the port's backward, mapped to the port's names by the linear weight
  bridge; per tensor ``|g_port - g_jax| <= 1e-4 |g_jax| + 1e-7``.
- Five train steps: the port's ``train_step`` with ``build_optimizer``
  against ``bench.py``'s step (value_and_grad, the optax
  ``build_optimizer`` chain with global-norm clipping, apply_updates) on the
  same batches: losses rtol 2e-4 (tests/test_training_dynamics.py's gate),
  parameters after the last step atol 2e-5 (five AdamW steps of lr 1e-4 move
  an element whose gradient is round-off by up to 5e-4, so elements are held
  to a tenth of that), and for the resnet skip blocks the BatchNorm running
  statistics against the step's ``batch_stats``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from poseidon_tpu import ScOT as JScOT
from poseidon_tpu.models.scot import apply_pixel_mask as j_apply_pixel_mask
from poseidon_tpu.models.scot import scot_loss as j_scot_loss
from poseidon_tpu.training.optimizer import build_optimizer as j_build_optimizer

import poseidon_tpu_torch as pt

from test_torch_model import CASES, build_pair, port_model

torch.set_num_threads(1)

REL, ABS = 1e-4, 1e-7
LR, WD, CLIP, STEPS = 1e-4, 1e-6, 1.0, 5


def make_batch(cfg, seed, batch=2):
    rng = np.random.default_rng(seed)
    s = cfg.image_size
    mask = np.zeros((batch, cfg.num_out_channels), bool)
    mask[:, -1] = True
    return {"pixel_values": rng.normal(size=(batch, cfg.num_channels, s, s)).astype(np.float32),
            "time": rng.uniform(0.1, 1.0, size=(batch,)).astype(np.float32),
            "labels": rng.normal(size=(batch, cfg.num_out_channels, s, s)).astype(np.float32),
            "pixel_mask": mask}


def jax_loss_fn(jcfg):
    model = JScOT(config=jcfg)

    def loss_fn(params, batch_stats, batch):
        variables = {"params": params}
        if batch_stats is not None:
            variables["batch_stats"] = batch_stats
        out = model.apply(variables, batch["pixel_values"], batch["time"], deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)},
                          mutable=["batch_stats"] if batch_stats is not None else False)
        pred, new_bs = (out[0], out[1]["batch_stats"]) if batch_stats is not None else (out, None)
        pred = j_apply_pixel_mask(pred, batch["labels"], batch["pixel_mask"])
        return j_scot_loss(pred, batch["labels"], jcfg), new_bs

    return loss_fn


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case, impl):
    jcfg, jvars, pcfg, sd = build_pair(**CASES[case])
    jcfg = jcfg.replace(attention_impl=impl)
    batch = make_batch(pcfg, seed=21)
    grad_fn = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg), has_aux=True))
    (loss_j, _), grads_j = grad_fn(jvars["params"], jvars.get("batch_stats"),
                                   jax.tree.map(jnp.asarray, batch))
    ref = pt.from_jax_params(jax.tree.map(np.asarray, grads_j), pcfg)

    model = port_model(pcfg, sd, impl).train()
    b = to_torch(batch)
    pred = pt.apply_pixel_mask(model(b["pixel_values"], b["time"]), b["labels"], b["pixel_mask"])
    loss = pt.scot_loss(pred, b["labels"], pcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        err = float((p.grad - ref[name]).norm())
        assert err <= REL * float(ref[name].norm()) + ABS, (name, err, float(ref[name].norm()))


@pytest.mark.parametrize("case", ["conditioned", "unconditioned_resnet_no_qkv_bias"])
def test_five_train_steps_match_jax(case):
    jcfg, jvars, pcfg, sd = build_pair(**CASES[case])
    jcfg = jcfg.replace(attention_impl="pallas")
    batches = [make_batch(pcfg, seed=30 + i) for i in range(STEPS)]

    params, bs = jvars["params"], jvars.get("batch_stats")
    tx = j_build_optimizer(params, learning_rate=LR, total_steps=100, weight_decay=WD,
                           lr_scheduler_type="cosine", warmup_ratio=0.0, max_grad_norm=CLIP)
    loss_fn = jax_loss_fn(jcfg)

    @jax.jit
    def step(params, opt_state, bs, batch):
        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, bs, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, new_bs, loss

    opt_state = tx.init(params)
    j_losses = []
    for batch in batches:
        params, opt_state, bs, loss = step(params, opt_state, bs, jax.tree.map(jnp.asarray, batch))
        j_losses.append(float(loss))

    model = port_model(pcfg, sd, "pallas")
    opt, sched = pt.build_optimizer(model, learning_rate=LR, total_steps=100, weight_decay=WD,
                                    lr_scheduler_type="cosine", warmup_ratio=0.0)
    p_losses = []
    for batch in batches:
        out = pt.train_step(model, opt, sched, to_torch(batch), max_grad_norm=CLIP)
        p_losses.append(float(out["loss"]))
        assert np.isfinite(float(out["grad_norm"]))
    np.testing.assert_allclose(p_losses, j_losses, rtol=2e-4)

    ref = pt.from_jax_params(jax.tree.map(np.asarray, params), pcfg,
                             None if bs is None else jax.tree.map(np.asarray, bs))
    state = model.state_dict()
    assert set(ref) == set(state)
    for name, value in ref.items():
        np.testing.assert_allclose(state[name].numpy(), value.numpy(), atol=2e-5, rtol=0,
                                   err_msg=name)
    if bs is not None:
        assert any("running_mean" in k for k in ref)
