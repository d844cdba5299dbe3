"""The port's fused block tail at the blocks its general kernels take on the
card (``csrc/mlp_cln_general.cu``: fp32, and widths past the Hopper tail
kernels'), in the model under ``fused_block_tail=True`` and
``attention_impl="pallas"``, against the JAX model on the same weights
(``from_jax_params``), on the CPU: the port runs the tail's plain versions,
the JAX package its Pallas kernels in interpret mode.

- A toy fp32 ScOT whose stage 0 is C = 64 (outside ``KERNEL_WIDTHS``), 256
  tokens an image: forward, whole-model gradients and one train step,
  tolerances as tests/test_torch_fused_tail.py (forward atol 2e-5, rtol
  1e-4; gradients ``|g_port - g_jax| <= 1e-4 |g_jax| + 1e-7`` per tensor;
  step loss rtol 2e-4, parameters atol 2e-5).
- The ``ODD`` ScOT of tests/test_torch_general_kernels.py (head width 24,
  F = 3C) in bf16: the same three checks by relative L2, with bf16's
  rounding in both models' activations (each rounds at its own points, so
  the outputs differ by a few bf16 ulps): forward 3e-2, as the chip's bf16
  kernel-vs-plain model gate; gradients 5e-2 over all parameters, as its
  gradient gate (a tensor of a few small values, such as a deep block's
  logit scales, moves more on its own); step loss rtol 3e-2 and the step's
  parameter update (AdamW's first step, about lr times the gradient's sign)
  relative L2 <= 0.25 (a gradient element near zero may take the other
  sign in the other model's rounding).

In each, the port's ``mlp_cln`` and the JAX package's ``fused_mlp_cln`` are
spied on: both run in the 2 * depths[0] stage-0 blocks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from poseidon_tpu import ScOT as JScOT
from poseidon_tpu.ops import mlp as jmlp
from poseidon_tpu.models.scot import apply_pixel_mask as j_apply_pixel_mask
from poseidon_tpu.models.scot import scot_loss as j_scot_loss
from poseidon_tpu.training.optimizer import build_optimizer as j_build_optimizer

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.models import scot as scot_mod
from poseidon_tpu_torch.ops import mlp as mlp_op

from test_torch_fused_tail import _tail_scales_near_one
from test_torch_general_kernels import ODD
from test_torch_model import ATOL, RTOL, build_pair, inputs
from test_torch_train_step import ABS, REL, make_batch, to_torch

torch.set_num_threads(1)

TAIL = dict(attention_impl="pallas", fused_block_tail=True)
C64 = dict(image_size=64, embed_dim=64, depths=(2, 2), num_heads=(2, 4),
           skip_connections=(1, 0), **TAIL)
LR, WD, CLIP = 1e-4, 1e-6, 1.0
BF16_OUT, BF16_GRAD, BF16_STEP_LOSS, BF16_UPDATE = 3e-2, 5e-2, 3e-2, 0.25

CONFIGS = {"fp32_c64": (C64, "float32"), "bf16_odd": ({**ODD, **TAIL}, "bfloat16")}


@functools.lru_cache(maxsize=None)
def tail_pair(name):
    """(jax config, jax variables, port config, port state dict, dtype
    name), the post-MLP norm scales near 1 so that the tail matters."""
    overrides, dtype = CONFIGS[name]
    jcfg, jvars, pcfg, _ = build_pair(**overrides)
    jvars = {**jvars, "params": _tail_scales_near_one(jvars["params"])}
    sd = pt.from_jax_params(jvars["params"], pcfg, jvars.get("batch_stats"))
    return jcfg, jvars, pcfg, sd, dtype


def port_model(pcfg, sd, dtype):
    model = pt.ScOT(pcfg, dtype=getattr(torch, dtype))
    model.load_state_dict(sd, strict=True)
    return model


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_loss_fn(jcfg, dtype):
    model = JScOT(config=jcfg, dtype=getattr(jnp, dtype))

    def loss_fn(params, batch):
        pred = model.apply({"params": params}, batch["pixel_values"], batch["time"],
                           deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        pred = j_apply_pixel_mask(pred.astype(jnp.float32), batch["labels"],
                                  batch["pixel_mask"])
        return j_scot_loss(pred, batch["labels"], jcfg)

    return loss_fn


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax_through_the_tail(name, monkeypatch):
    jcfg, jvars, pcfg, sd, dtype = tail_pair(name)
    jtail = _spy(monkeypatch, jmlp, "fused_mlp_cln")
    tail = _spy(monkeypatch, scot_mod, "mlp_cln")
    x, t = inputs(pcfg, seed=1)
    apply = jax.jit(JScOT(config=jcfg, dtype=getattr(jnp, dtype)).apply)
    y_j = np.asarray(apply(jvars, jnp.asarray(x), jnp.asarray(t)), np.float32)
    model = port_model(pcfg, sd, dtype).eval()
    with torch.no_grad():
        y_p = model(torch.from_numpy(x), torch.from_numpy(t)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(y_p, y_j, atol=ATOL, rtol=RTOL)
    else:
        assert rel_l2(y_p, y_j) <= BF16_OUT
    assert len(tail) == 2 * pcfg.depths[0]
    assert len(jtail) == 2 * pcfg.depths[0], "the JAX model did not take its MLP+CLN kernel"


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def one_step(request):
    """The JAX step (value_and_grad, the optax chain, apply_updates) and the
    port's loss, gradients and train step on one batch, each model's tail
    calls counted."""
    jcfg, jvars, pcfg, sd, dtype = tail_pair(request.param)
    batch = make_batch(pcfg, seed=41)
    params = jvars["params"]
    tx = j_build_optimizer(params, learning_rate=LR, total_steps=100, weight_decay=WD,
                           lr_scheduler_type="cosine", warmup_ratio=0.0, max_grad_norm=CLIP)
    loss_fn = jax_loss_fn(jcfg, dtype)
    with pytest.MonkeyPatch.context() as mp:
        jtail = _spy(mp, jmlp, "fused_mlp_cln")

        @jax.jit
        def step(params, opt_state, batch):
            loss, grads = jax.value_and_grad(loss_fn)(params, batch)
            updates, _ = tx.update(grads, opt_state, params)
            return loss, grads, optax.apply_updates(params, updates)

        loss_j, grads_j, params_j = step(params, tx.init(params),
                                         jax.tree.map(jnp.asarray, batch))
    b = to_torch(batch)
    with pytest.MonkeyPatch.context() as mp:
        tail = _spy(mp, scot_mod, "mlp_cln")
        model = port_model(pcfg, sd, dtype).train()
        pred = pt.apply_pixel_mask(model(b["pixel_values"], b["time"]).float(), b["labels"],
                                   b["pixel_mask"])
        loss = pt.scot_loss(pred, b["labels"], pcfg)
        loss.backward()
        stepped = port_model(pcfg, sd, dtype)
        opt, sched = pt.build_optimizer(stepped, learning_rate=LR, total_steps=100,
                                        weight_decay=WD, lr_scheduler_type="cosine",
                                        warmup_ratio=0.0)
        out = pt.train_step(stepped, opt, sched, b, max_grad_norm=CLIP)
    return dict(pcfg=pcfg, dtype=dtype, loss_j=float(loss_j), loss=float(loss.detach()),
                grads_j=pt.from_jax_params(jax.tree.map(np.asarray, grads_j), pcfg),
                grads={n: p.grad for n, p in model.named_parameters()},
                params_j=pt.from_jax_params(jax.tree.map(np.asarray, params_j), pcfg),
                step_loss=float(out["loss"]), stepped=stepped.state_dict(), before=sd,
                tail_calls=len(tail), jax_tail_calls=len(jtail))


def test_gradients_match_jax(one_step):
    r = one_step
    blocks = 2 * r["pcfg"].depths[0]
    assert r["tail_calls"] == 2 * blocks  # the forward's, then the train step's
    assert r["jax_tail_calls"] == blocks, "the JAX step did not take its MLP+CLN kernel"
    for name in ("layernorm_after.weight.weight", "layernorm_after.bias.weight",
                 "intermediate.dense.weight", "output.dense.bias"):
        assert float(r["grads"][f"encoder.layers.0.blocks.0.{name}"].abs().max()) > 0, name
    if r["dtype"] == "float32":
        np.testing.assert_allclose(r["loss"], r["loss_j"], rtol=1e-5)
    else:
        np.testing.assert_allclose(r["loss"], r["loss_j"], rtol=BF16_STEP_LOSS)
    ours, refs = [], []
    for name, g in r["grads"].items():
        ref = r["grads_j"][name]
        assert g is not None and torch.isfinite(g).all(), name
        if r["dtype"] == "float32":
            err = float((g - ref).norm())
            assert err <= REL * float(ref.norm()) + ABS, (name, err, float(ref.norm()))
        ours.append(g.flatten())
        refs.append(ref.flatten())
    err = rel_l2(torch.cat(ours).numpy(), torch.cat(refs).numpy())
    print(f"{r['dtype']}: whole-gradient relative L2 {err:.3e}")
    assert err <= BF16_GRAD


def test_one_train_step_matches_optax(one_step):
    r = one_step
    assert set(r["params_j"]) == set(r["stepped"])
    if r["dtype"] == "float32":
        np.testing.assert_allclose(r["step_loss"], r["loss_j"], rtol=2e-4)
        for name, value in r["params_j"].items():
            np.testing.assert_allclose(r["stepped"][name].numpy(), value.numpy(), atol=2e-5,
                                       rtol=0, err_msg=name)
        return
    np.testing.assert_allclose(r["step_loss"], r["loss_j"], rtol=BF16_STEP_LOSS)
    names = sorted(r["params_j"])
    ours = torch.cat([(r["stepped"][n] - r["before"][n]).flatten().float() for n in names])
    refs = torch.cat([(r["params_j"][n] - r["before"][n]).flatten().float() for n in names])
    assert float(refs.norm()) > 0
    err = rel_l2(ours.numpy(), refs.numpy())
    print(f"bf16: the step's update, relative L2 {err:.3e}")
    assert err <= BF16_UPDATE
