"""The port's fused block tail in the model (``fused_block_tail=True`` under
``attention_impl="pallas"``) against the JAX package, on the CPU, fp32, at
the toy geometry whose stage 0 (C = 96, 256 tokens an image) takes the tail
kernel in both packages: image 64, embed 96, depths (2, 2), heads (3, 6).
The JAX side runs its Pallas kernels in interpret mode (``_fwd_kernel_dm_cln``
and ``_bwd_kernel_dm_cln`` among them), the port its kernels' plain versions.
The post-MLP norms' scale biases are set near 1, so that the tail matters to
the output.

- Forward: atol 2e-5, rtol 1e-4 (tests/test_torch_model.py).
- Whole-model gradients of the pixel-masked grouped L1 loss, per tensor
  ``|g_port - g_jax| <= 1e-4 |g_jax| + 1e-7`` (tests/test_torch_train_step.py),
  and one train step against the optax step: loss rtol 2e-4, parameters
  atol 2e-5.
- The fused branch is taken in exactly the 2 * depths[0] stage-0 blocks of
  encoder and decoder, the unfused MLP wrapper in none; the port's gate
  agrees with the JAX package's at every stage of ScOT-T and ScOT-B 128x128 and, by
  design, not at ScOT-L; the fused-tail JAX tree loads strictly; under
  drop-path 0.2 in train mode the fused and unfused port branches drop the
  same samples for the same generator."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from poseidon_tpu import ScOT as JScOT
from poseidon_tpu import make_config as jmake_config
from poseidon_tpu.ops import mlp as jmlp
from poseidon_tpu.training.optimizer import build_optimizer as j_build_optimizer

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.ops import mlp as mlp_op

from test_torch_model import ATOL, RTOL, build_pair, inputs, port_model
from test_torch_train_step import ABS, REL, jax_loss_fn, make_batch, to_torch

torch.set_num_threads(1)

FUSED = dict(image_size=64, embed_dim=96, depths=(2, 2), num_heads=(3, 6),
             skip_connections=(1, 0), attention_impl="pallas", fused_block_tail=True)
LR, WD, CLIP = 1e-4, 1e-6, 1.0


def _tail_scales_near_one(tree):
    """The tree with every post-MLP norm's cond_scale bias moved by +1."""
    out = {}
    for k, v in tree.items():
        if not isinstance(v, dict):
            out[k] = v
        elif k == "norm_mlp":
            out[k] = {**v, "cond_scale": {**v["cond_scale"], "bias": v["cond_scale"]["bias"] + 1}}
        else:
            out[k] = _tail_scales_near_one(v)
    return out


@functools.lru_cache(maxsize=None)
def fused_pair():
    jcfg, jvars, pcfg, _ = build_pair(**FUSED)
    jvars = {**jvars, "params": _tail_scales_near_one(jvars["params"])}
    return jcfg, jvars, pcfg, pt.from_jax_params(jvars["params"], pcfg, jvars.get("batch_stats"))


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a: calls.append(1) or orig(*a))
    return calls


def test_forward_matches_jax_and_takes_the_tail_in_stage0_blocks(monkeypatch):
    jtail = _spy(monkeypatch, jmlp, "_call_fwd_dm_cln")
    tail = _spy(monkeypatch, mlp_op, "mlp_cln_plain")
    unfused = _spy(monkeypatch, mlp_op, "mlp")
    jcfg, jvars, pcfg, sd = fused_pair()
    x, t = inputs(pcfg, seed=1)
    y_j = np.asarray(jax.jit(JScOT(config=jcfg).apply)(jvars, jnp.asarray(x), jnp.asarray(t)))
    model = port_model(pcfg, sd, "pallas")
    with torch.no_grad():
        y_p = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(y_p, y_j, atol=ATOL, rtol=RTOL)
    blocks = [m for m in model.modules() if isinstance(m, pt.models.scot.SwinBlock)]
    fused = [m.uses_fused_tail(torch.from_numpy(t), m.resolution ** 2) for m in blocks]
    assert sum(fused) == 2 * pcfg.depths[0] == len(tail)
    assert unfused == []
    assert jtail, "the JAX model did not take its MLP+CLN kernel"


def test_gate_matches_jax_at_scot_b_and_differs_at_scot_l():
    """ScOT-T and ScOT-B 128x128: both take stages 0-1. ScOT-L: the JAX
    package's TPU VMEM budget refuses every stage, the port's gate takes
    stages 0-1; both compute the same function there."""
    picked = {}
    for size in ("T", "B", "L"):
        cfg = pt.make_config(size, image_size=128, num_channels=4, num_out_channels=4)
        picked[size] = []
        for i in range(cfg.num_stages):
            c, l = cfg.stage_dim(i), cfg.stage_resolution(i) ** 2
            jax_takes = jmlp.dm_eligible((32, l, c), c, int(cfg.mlp_ratio * c), 2, cln=True)
            picked[size].append((mlp_op.use_fused_tail(c, l), jax_takes))
    assert picked["T"] == [(True, True), (True, True), (False, False), (False, False)]
    assert picked["B"] == [(True, True), (True, True), (False, False), (False, False)]
    assert picked["L"] == [(True, False), (True, False), (False, False), (False, False)]


def test_fused_tail_jax_tree_loads_strictly():
    jcfg, jvars, pcfg, sd = fused_pair()
    unfused = jmake_config("T", **{**dict(jcfg.to_dict()), "fused_block_tail": False,
                                   "attention_impl": "xla"})
    x0 = jnp.zeros((1, pcfg.num_channels, pcfg.image_size, pcfg.image_size))
    shapes = [jax.tree.map(lambda a: a.shape,
                           jax.eval_shape(JScOT(config=c).init, jax.random.PRNGKey(0), x0,
                                          jnp.zeros((1,))))
              for c in (jcfg, unfused)]
    assert shapes[0] == shapes[1], "the fused tail changed the JAX parameter tree"
    model = pt.ScOT(pcfg)
    model.load_state_dict(sd, strict=True)
    assert model.config.fused_block_tail and set(sd) == set(model.state_dict())


@pytest.fixture(scope="module")
def one_step():
    """The JAX step (value_and_grad, the optax chain, apply_updates) and the
    port's loss, gradients and train step on one batch."""
    jcfg, jvars, pcfg, sd = fused_pair()
    batch = make_batch(pcfg, seed=41)
    params = jvars["params"]
    tx = j_build_optimizer(params, learning_rate=LR, total_steps=100, weight_decay=WD,
                           lr_scheduler_type="cosine", warmup_ratio=0.0, max_grad_norm=CLIP)
    loss_fn = jax_loss_fn(jcfg)

    @jax.jit
    def step(params, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, None, batch)
        updates, _ = tx.update(grads, opt_state, params)
        return loss, grads, optax.apply_updates(params, updates)

    loss_j, grads_j, params_j = step(params, tx.init(params), jax.tree.map(jnp.asarray, batch))
    b = to_torch(batch)
    model = port_model(pcfg, sd, "pallas").train()
    pred = pt.apply_pixel_mask(model(b["pixel_values"], b["time"]), b["labels"], b["pixel_mask"])
    loss = pt.scot_loss(pred, b["labels"], pcfg)
    loss.backward()
    stepped = port_model(pcfg, sd, "pallas")
    opt, sched = pt.build_optimizer(stepped, learning_rate=LR, total_steps=100, weight_decay=WD,
                                    lr_scheduler_type="cosine", warmup_ratio=0.0)
    out = pt.train_step(stepped, opt, sched, b, max_grad_norm=CLIP)
    return dict(pcfg=pcfg, loss_j=float(loss_j), loss=float(loss.detach()),
                grads_j=pt.from_jax_params(jax.tree.map(np.asarray, grads_j), pcfg),
                grads={n: p.grad for n, p in model.named_parameters()},
                params_j=pt.from_jax_params(jax.tree.map(np.asarray, params_j), pcfg),
                step_loss=float(out["loss"]), stepped=stepped.state_dict())


def test_gradients_match_jax(one_step):
    r = one_step
    np.testing.assert_allclose(r["loss"], r["loss_j"], rtol=1e-5)
    for name, g in r["grads"].items():
        ref = r["grads_j"][name]
        assert g is not None and torch.isfinite(g).all(), name
        err = float((g - ref).norm())
        assert err <= REL * float(ref.norm()) + ABS, (name, err, float(ref.norm()))
    for name in ("layernorm_after.weight.weight", "layernorm_after.bias.weight",
                 "intermediate.dense.weight", "output.dense.bias"):
        assert float(r["grads"][f"encoder.layers.0.blocks.0.{name}"].abs().max()) > 0, name


def test_one_train_step_matches_optax(one_step):
    r = one_step
    np.testing.assert_allclose(r["step_loss"], r["loss_j"], rtol=2e-4)
    assert set(r["params_j"]) == set(r["stepped"])
    for name, value in r["params_j"].items():
        np.testing.assert_allclose(r["stepped"][name].numpy(), value.numpy(), atol=2e-5, rtol=0,
                                   err_msg=name)


def test_fused_and_unfused_drop_the_same_samples():
    """Under drop-path 0.2 in train mode, the same generator state gives the
    fused and unfused branches the same keep masks, so the same output."""
    _, _, pcfg, sd = fused_pair()
    cfg = pcfg.replace(drop_path_rate=0.2)
    x, t = (torch.from_numpy(a) for a in inputs(pcfg, seed=3, batch=4))
    outs = []
    for fused, seed in ((True, 5), (False, 5), (True, 6)):
        model = pt.ScOT(cfg.replace(fused_block_tail=fused))
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            outs.append(model.train()(x, t, generator=torch.Generator().manual_seed(seed)))
    torch.testing.assert_close(outs[0], outs[1], atol=1e-6, rtol=1e-5)
    assert not torch.allclose(outs[0], outs[2], atol=1e-3), "another seed dropped the same samples"
