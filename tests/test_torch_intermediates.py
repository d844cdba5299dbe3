"""``forward_with_intermediates`` and ``rollout_with_intermediates`` of the
port against the JAX package's, on the same weights (numpy values around
the JAX init, carried over by ``from_jax_params``) and inputs: the same
number and order of hidden states (encoder stages ascending, then decoder
stages deepest-first) and of attention probabilities (every block in
execution order), each within relative L2 1e-5 (fp32), and the
prediction. The JAX model is built from a ``"pallas"`` / ``scan_blocks``
config, which the JAX function retraces on its plain path; the port's
model keeps ``"pallas"`` and takes the plain path only for the call: its
config, its kernel path and its launch counts are unchanged afterwards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu import ScOT as JScOT
from poseidon_tpu import make_config as jmake_config
from poseidon_tpu.models.scot import forward_with_intermediates as jforward
from poseidon_tpu.training.rollout import rollout_with_intermediates as jrollout

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.ops import mlp as mlp_op
from poseidon_tpu_torch.ops import window_attention as wa

from test_torch_model import _values

torch.set_num_threads(1)

TOL = 1e-5
TOY = dict(image_size=32, patch_size=4, num_channels=3, num_out_channels=2, embed_dim=24,
           depths=(2, 2, 2), num_heads=(2, 2, 4), skip_connections=(1, 1, 0), window_size=4,
           mlp_ratio=2.0, channel_slice_list=(0, 1, 2), use_conditioning=True)


def _pair(**overrides):
    jcfg = jmake_config("T", **dict(TOY, **overrides))
    x0 = jnp.zeros((1, 3, jcfg.image_size, jcfg.image_size))
    shapes = jax.eval_shape(JScOT(config=jcfg).init, jax.random.PRNGKey(0), x0, jnp.zeros((1,)))
    jvars = _values(dict(shapes), np.random.default_rng(0))
    pcfg = pt.ScOTConfig.from_dict(jcfg.to_dict())
    model = pt.ScOT(pcfg)
    model.load_state_dict(pt.from_jax_params(jvars["params"], pcfg), strict=True)
    return JScOT(config=jcfg), jvars, model.eval()


def _inputs(seed=1, batch=2, size=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, 3, size, size)).astype(np.float32),
            rng.uniform(0.1, 1.0, size=batch).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _assert_lists(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().numpy()
        assert g.shape == tuple(w.shape), (what, i)
        assert _rel(g, w) <= TOL, (what, i, _rel(g, w))


@pytest.mark.parametrize("overrides", [{}, {"attention_impl": "pallas", "scan_blocks": True}],
                         ids=["xla", "pallas_scan"])
def test_forward_with_intermediates_matches_jax(overrides):
    jmodel, jvars, model = _pair(**overrides)
    x, t = _inputs()
    jpred, jhs, jatt = jforward(jmodel, jvars, x, t)
    pred, hs, att = pt.forward_with_intermediates(model, torch.from_numpy(x), torch.from_numpy(t))
    assert _rel(pred.detach().numpy(), jpred) <= TOL
    # 3 encoder stages, then 3 decoder stages; 12 blocks.
    assert len(hs) == 6 and len(att) == 12
    _assert_lists(hs, jhs, "hidden_states")
    _assert_lists(att, jatt, "attentions")
    for a in att:
        assert torch.allclose(a.sum(-1), torch.ones(()), atol=1e-5)


def test_model_unchanged_and_kernel_path_kept(monkeypatch):
    # On the CPU the kernel wrappers run their plain versions: a spy on
    # those counts the model's kernel calls.
    calls = {"attn": 0, "mlp": 0}
    orig_attn, orig_mlp = wa.window_attention_plain, mlp_op.mlp_plain

    def spy(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(wa, "window_attention_plain", spy("attn", orig_attn))
    monkeypatch.setattr(mlp_op, "mlp_plain", spy("mlp", orig_mlp))
    # 64x64: 256 tokens an image at stage 0, where the MLP kernel runs.
    _, _, model = _pair(attention_impl="pallas", image_size=64)
    x, t = (torch.from_numpy(a) for a in _inputs(size=64))
    with torch.no_grad():
        ref = model(x, t)
    per_forward = dict(calls)
    assert per_forward["attn"] == 12 and per_forward["mlp"] > 0
    pred, _, att = pt.forward_with_intermediates(model, x, t)
    assert calls == per_forward
    assert model.config.attention_impl == "pallas" and len(att) == 12
    assert _rel(pred.detach().numpy(), ref.numpy()) <= TOL
    with torch.no_grad():
        again = model(x, t)
    assert torch.equal(again, ref)
    assert calls == {k: 2 * v for k, v in per_forward.items()}


def test_rollout_with_intermediates_matches_jax():
    jmodel, jvars, model = _pair(num_out_channels=2)
    x, t = _inputs(batch=2)
    jpred, jhs, jatt = jrollout(jmodel, jvars, x, t, 2)
    pred, hs, att = pt.rollout_with_intermediates(model, torch.from_numpy(x),
                                                  torch.from_numpy(t), 2)
    assert pred.shape == (2, 2, 2, 32, 32) == tuple(jpred.shape)
    assert _rel(pred.detach().numpy(), jpred) <= TOL
    assert hs[0].shape[:2] == (2, 2) and att[0].shape[1] == 2
    _assert_lists(hs, jhs, "hidden_states")
    _assert_lists(att, jatt, "attentions")
