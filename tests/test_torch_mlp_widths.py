"""The port's MLP at width 48, the stage-0 width of ScOT-T and ScOT-S, in a
whole model against the JAX package, on the CPU, fp32: a toy ScOT with
embed_dim 48 (head width 16), image 64 and patch 4, so that stage 0 has
256 tokens an image and both packages take their MLP kernel there (the
JAX side its Pallas kernels in interpret mode, the port its op with the
kernels' plain versions), with and without ``fused_block_tail``. Spies
show that every stage-0 block of encoder and decoder goes through the op
(``mlp_op.mlp``, or ``mlp_op.mlp_cln`` under the fused tail) and that the
JAX model takes its D-major kernel.

- Forward: atol 2e-5, rtol 1e-4 (tests/test_torch_model.py).
- Whole-model gradients of the pixel-masked grouped L1 loss, per tensor
  ``|g_port - g_jax| <= 1e-4 |g_jax| + 1e-7`` (tests/test_torch_train_step.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu import ScOT as JScOT
from poseidon_tpu.ops import mlp as jmlp

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.models import scot as scot_mod
from poseidon_tpu_torch.ops import mlp as mlp_op

from test_torch_fused_tail import _tail_scales_near_one
from test_torch_model import ATOL, RTOL, build_pair, inputs, port_model
from test_torch_train_step import ABS, REL, jax_loss_fn, make_batch, to_torch

torch.set_num_threads(1)

WIDTH48 = dict(image_size=64, embed_dim=48, depths=(1, 1), num_heads=(3, 6),
               skip_connections=(1, 0), attention_impl="pallas")


@functools.lru_cache(maxsize=None)
def pair(fused):
    jcfg, jvars, pcfg, _ = build_pair(**WIDTH48, fused_block_tail=fused)
    if fused:
        jvars = {**jvars, "params": _tail_scales_near_one(jvars["params"])}
    return jcfg, jvars, pcfg, pt.from_jax_params(jvars["params"], pcfg, jvars.get("batch_stats"))


def _spy(monkeypatch, module, name, target=None):
    calls = []
    orig = getattr(target or module, name)
    monkeypatch.setattr(module, name, lambda *a: calls.append(a) or orig(*a))
    return calls


def _spies(monkeypatch, fused):
    """(port op calls, JAX kernel calls) of the branch the model takes."""
    if fused:
        return (_spy(monkeypatch, scot_mod, "mlp_cln", mlp_op),
                _spy(monkeypatch, jmlp, "_call_fwd_dm_cln"))
    return _spy(monkeypatch, mlp_op, "mlp"), _spy(monkeypatch, jmlp, "_call_fwd_dm")


def _stage0_blocks(pcfg):
    return 2 * pcfg.depths[0]  # encoder and decoder


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_tail"])
def test_forward_matches_jax_and_stage0_takes_the_op(fused, monkeypatch):
    ours, theirs = _spies(monkeypatch, fused)
    jcfg, jvars, pcfg, sd = pair(fused)
    assert mlp_op.use_mlp_kernel(48, (pcfg.image_size // pcfg.patch_size) ** 2)
    x, t = inputs(pcfg, seed=1)
    y_j = np.asarray(jax.jit(JScOT(config=jcfg).apply)(jvars, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        y_p = port_model(pcfg, sd, "pallas")(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(y_p, y_j, atol=ATOL, rtol=RTOL)
    assert len(ours) == _stage0_blocks(pcfg)
    assert all(a[0].shape[-1] == 48 for a in ours)
    assert theirs, "the JAX model did not take its D-major kernel"


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_tail"])
def test_gradients_match_jax(fused, monkeypatch):
    ours, _ = _spies(monkeypatch, fused)
    jcfg, jvars, pcfg, sd = pair(fused)
    batch = make_batch(pcfg, seed=21)
    grad_fn = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg), has_aux=True))
    (loss_j, _), grads_j = grad_fn(jvars["params"], jvars.get("batch_stats"),
                                   jax.tree.map(jnp.asarray, batch))
    ref = pt.from_jax_params(jax.tree.map(np.asarray, grads_j), pcfg)
    model = port_model(pcfg, sd, "pallas").train()
    b = to_torch(batch)
    pred = pt.apply_pixel_mask(model(b["pixel_values"], b["time"]), b["labels"], b["pixel_mask"])
    loss = pt.scot_loss(pred, b["labels"], pcfg)
    loss.backward()
    assert len(ours) == _stage0_blocks(pcfg)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        err = float((p.grad - ref[name]).norm())
        assert err <= REL * float(ref[name].norm()) + ABS, (name, err, float(ref[name].norm()))
    w1 = dict(model.named_parameters())["encoder.layers.0.blocks.0.intermediate.dense.weight"]
    assert float(w1.grad.abs().max()) > 0, "the stage-0 MLP weights got no gradient"
