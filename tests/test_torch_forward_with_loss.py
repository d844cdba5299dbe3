"""``poseidon_tpu_torch.forward_with_loss`` against the JAX package's
``forward_with_loss`` on the CPU, on tests/test_torch_model.py's toy model
and weights (carried over by ``from_jax_params``): the loss and the masked
prediction with no pixel mask, a per-channel (B, C) and a per-pixel
(B, C, H, W) one, for both ``attention_impl`` values; and in train mode
with the resnet skip blocks, whose BatchNorm running statistics must match
the ``batch_stats`` that JAX returns under ``mutable=["batch_stats"]``.
Tolerance atol 2e-5, rtol 1e-4 (that file's fp32 gates)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu import ScOT as JScOT
from poseidon_tpu.models import forward_with_loss as jax_forward_with_loss

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.training import trainer as trainer_mod

from test_torch_model import ATOL, CASES, RTOL, build_pair, inputs, port_model

torch.set_num_threads(1)

MASKS = ("none", "channel", "pixel")


def _labels_and_mask(cfg, kind, seed, batch=2):
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.num_out_channels, cfg.image_size, cfg.image_size)
    labels = rng.normal(size=shape).astype(np.float32)
    if kind == "none":
        return labels, None
    if kind == "channel":
        mask = np.zeros(shape[:2], dtype=bool)
        mask[0, 1] = mask[1, 0] = True
    else:
        mask = rng.uniform(size=shape) < 0.3
    return labels, mask


def _jax_call(jcfg, jvars, impl, x, t, labels, mask, **kw):
    model = JScOT(config=jcfg.replace(attention_impl=impl))
    fn = jax.jit(functools.partial(jax_forward_with_loss, model, **kw))
    return fn(jvars, jnp.asarray(x), jnp.asarray(t), jnp.asarray(labels),
              None if mask is None else jnp.asarray(mask))


def _port_call(model, x, t, labels, mask):
    return pt.forward_with_loss(model, torch.from_numpy(x), torch.from_numpy(t),
                                torch.from_numpy(labels),
                                None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("mask_kind", MASKS)
def test_forward_with_loss_matches_jax(mask_kind, impl):
    jcfg, jvars, pcfg, sd = build_pair()
    x, t = inputs(pcfg, seed=3)
    labels, mask = _labels_and_mask(pcfg, mask_kind, seed=4)
    loss_j, pred_j = _jax_call(jcfg, jvars, impl, x, t, labels, mask)
    with torch.no_grad():
        loss_p, pred_p = _port_call(port_model(pcfg, sd, impl), x, t, labels, mask)
    np.testing.assert_allclose(pred_p.numpy(), np.asarray(pred_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(loss_p), float(loss_j), atol=ATOL, rtol=RTOL)
    if mask is not None:   # the masked entries are the labels
        full = np.broadcast_to(mask.reshape(mask.shape + (1,) * (4 - mask.ndim)), labels.shape)
        np.testing.assert_array_equal(pred_p.numpy()[full], labels[full])


def test_forward_with_loss_train_mode_batch_stats_match_jax():
    jcfg, jvars, pcfg, sd = build_pair(**CASES["unconditioned_resnet_no_qkv_bias"])
    x, t = inputs(pcfg, seed=5)
    labels, mask = _labels_and_mask(pcfg, "channel", seed=6)
    (loss_j, pred_j), new_vars = _jax_call(jcfg, jvars, "pallas", x, t, labels, mask,
                                           deterministic=False, mutable=["batch_stats"])
    model = port_model(pcfg, sd, "pallas").train()
    with torch.no_grad():
        loss_p, pred_p = _port_call(model, x, t, labels, mask)
    np.testing.assert_allclose(pred_p.numpy(), np.asarray(pred_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(loss_p), float(loss_j), atol=ATOL, rtol=RTOL)
    ref = pt.from_jax_params(jvars["params"], pcfg,
                             jax.tree.map(np.asarray, new_vars["batch_stats"]))
    ours = model.state_dict()
    stats = [k for k in ref if "running_" in k]
    assert stats
    for name in stats:
        assert not np.array_equal(ours[name].numpy(), sd[name].numpy()), name  # updated
        np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_trainer_direct_loss_is_forward_with_loss():
    _, _, pcfg, sd = build_pair()
    x, t = inputs(pcfg, seed=7)
    labels, mask = _labels_and_mask(pcfg, "pixel", seed=8)
    model = port_model(pcfg, sd, "pallas")
    batch = {"pixel_values": torch.from_numpy(x), "time": torch.from_numpy(t),
             "labels": torch.from_numpy(labels), "pixel_mask": torch.from_numpy(mask)}
    with torch.no_grad():
        direct = trainer_mod._direct_loss(model, batch, None)
        loss, _ = _port_call(model, x, t, labels, mask)
    assert torch.equal(direct, loss)
