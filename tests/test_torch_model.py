"""The PyTorch port's whole model and rollout against the JAX package, on
the CPU, at toy sizes: the same weights (numpy values around the JAX
init, carried over by ``from_jax_params``) and the same numpy inputs through both, for
both ``attention_impl`` values. Under ``"pallas"`` the JAX side runs its
Pallas kernels in interpret mode and the port its kernels' plain versions.
Tolerance atol 2e-5, rtol 1e-4 (fp32; the JAX package's own pallas-vs-xla
model tolerance)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poseidon_tpu import ScOT as JScOT
from poseidon_tpu import make_config as jmake_config
from poseidon_tpu.training.rollout import autoregressive_rollout as jax_rollout

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.ops import mlp as mlp_op
from poseidon_tpu_torch.ops import window_attention as attn_op

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4

TOY = dict(image_size=32, patch_size=4, num_channels=3, num_out_channels=2,
           embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2),
           skip_connections=(1, 1, 1, 0), window_size=4, mlp_ratio=2.0,
           channel_slice_list=(0, 1, 2), use_conditioning=True)

# The toy grid of tests/test_parity.py (conditioning on/off, convnext/resnet,
# learn_residual, qkv_bias off, shifted windows at every stage), folded into
# few configurations to keep the JAX compiles few; the packed-head geometry
# of tests/test_pallas_ops.py; and one whose stage 0 is wide and long enough
# for the port's MLP kernel (C=96, 256 tokens per image).
CASES = {
    "conditioned": dict(),
    "unconditioned_resnet_no_qkv_bias": dict(
        use_conditioning=False, residual_model="resnet", qkv_bias=False,
        depths=(2, 2), num_heads=(2, 2), skip_connections=(1, 1)),
    "learn_residual_window2": dict(
        learn_residual=True, window_size=2, depths=(2, 2), num_heads=(2, 2),
        skip_connections=(1, 0)),
    "packed_heads": dict(embed_dim=64, depths=(2, 2), num_heads=(8, 8),
                         skip_connections=(1, 0)),
    "mlp_kernel_stage": dict(image_size=64, embed_dim=96, depths=(2, 2),
                             num_heads=(3, 6), skip_connections=(1, 0)),
}
ROLLOUT_CASE = dict(depths=(2, 2), num_heads=(2, 2), skip_connections=(1, 0))


def _values(tree, rng, name=""):
    """Numpy values for a tree of shapes: N(0, 0.05) around each
    parameter's init value, so that biases and scales are not at init."""
    if isinstance(tree, dict):
        return {k: _values(v, rng, k) for k, v in tree.items()}
    noise = rng.normal(0.0, 0.05, size=tree.shape).astype(np.float32)
    if name == "scale":
        return 1.0 + noise
    if name == "logit_scale":
        return np.float32(np.log(10.0)) + noise
    if name == "var":
        return 1.0 + 4.0 * np.abs(noise)
    return noise


@functools.lru_cache(maxsize=None)
def _pair(key, seed=0):
    """(jax config, jax variables, port config, port state dict) for
    ``CASES``-style overrides given as a sorted item tuple."""
    kw = dict(TOY, **dict(key))
    jcfg = jmake_config("T", **kw)
    x0 = jnp.zeros((1, kw["num_channels"], kw["image_size"], kw["image_size"]))
    shapes = jax.eval_shape(JScOT(config=jcfg).init, jax.random.PRNGKey(0), x0, jnp.zeros((1,)))
    jvars = _values(dict(shapes), np.random.default_rng(seed))
    pcfg = pt.ScOTConfig.from_dict(jcfg.to_dict())
    sd = pt.from_jax_params(jvars["params"], pcfg, jvars.get("batch_stats"))
    return jcfg, jvars, pcfg, sd


def build_pair(**overrides):
    return _pair(tuple(sorted(overrides.items())))


def port_model(pcfg, sd, impl):
    model = pt.ScOT(pcfg.replace(attention_impl=impl))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def inputs(cfg, seed, size=None, batch=2):
    rng = np.random.default_rng(seed)
    size = size or cfg.image_size
    x = rng.normal(size=(batch, cfg.num_channels, size, size)).astype(np.float32)
    t = rng.uniform(0.1, 1.0, size=(batch,)).astype(np.float32)
    return x, t


def run_both(jcfg, jvars, pcfg, sd, impl, x, t):
    apply = jax.jit(JScOT(config=jcfg.replace(attention_impl=impl)).apply)
    y_j = np.asarray(apply(jvars, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        y_p = port_model(pcfg, sd, impl)(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    return y_p, y_j


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(case, impl):
    jcfg, jvars, pcfg, sd = build_pair(**CASES[case])
    x, t = inputs(pcfg, seed=1)
    y_p, y_j = run_both(jcfg, jvars, pcfg, sd, impl, x, t)
    assert y_p.shape == y_j.shape
    np.testing.assert_allclose(y_p, y_j, atol=ATOL, rtol=RTOL)


def test_kernel_paths_taken_on_cpu(monkeypatch):
    """Under "pallas" the model reaches the kernels' wrappers (their plain
    versions on the CPU) at every Swin block, and the MLP wrapper exactly at
    the stages the dispatch rule picks."""
    calls = {"attn": 0, "mlp": 0}
    orig_attn, orig_mlp = attn_op.window_attention_plain, mlp_op.mlp_plain

    def spy_attn(*a):
        calls["attn"] += 1
        return orig_attn(*a)

    def spy_mlp(*a):
        calls["mlp"] += 1
        return orig_mlp(*a)

    monkeypatch.setattr(attn_op, "window_attention_plain", spy_attn)
    monkeypatch.setattr(mlp_op, "mlp_plain", spy_mlp)
    _, _, pcfg, sd = build_pair(**CASES["mlp_kernel_stage"])
    x, t = inputs(pcfg, seed=2, batch=1)
    with torch.no_grad():
        port_model(pcfg, sd, "pallas")(torch.from_numpy(x), torch.from_numpy(t))
    assert calls["attn"] == 2 * sum(pcfg.depths)
    assert calls["mlp"] == 2 * pcfg.depths[0]  # stage 0 of encoder and decoder


@pytest.mark.parametrize("size", [16, 48])
def test_resampled_input_matches_jax(size):
    jcfg, jvars, pcfg, sd = build_pair()
    x, t = inputs(pcfg, seed=3, size=size, batch=1)
    y_p, y_j = run_both(jcfg, jvars, pcfg, sd, "xla", x, t)
    assert y_p.shape == (1, 2, size, size)
    np.testing.assert_allclose(y_p, y_j, atol=5e-5, rtol=RTOL)


def test_loss_and_pixel_mask_match_jax():
    from poseidon_tpu.models.scot import apply_pixel_mask as j_mask
    from poseidon_tpu.models.scot import scot_loss as j_loss

    jcfg, _, pcfg, _ = build_pair()
    rng = np.random.default_rng(4)
    pred = rng.normal(size=(3, 2, 8, 8)).astype(np.float32)
    lab = rng.normal(size=(3, 2, 8, 8)).astype(np.float32)
    mask = np.array([[True, False], [False, False], [False, True]])
    w = np.array([1.0, 0.0, 1.0], np.float32)
    p_m = pt.apply_pixel_mask(torch.from_numpy(pred), torch.from_numpy(lab), torch.from_numpy(mask))
    j_m = j_mask(jnp.asarray(pred), jnp.asarray(lab), jnp.asarray(mask))
    np.testing.assert_array_equal(p_m.numpy(), np.asarray(j_m))
    for cfg_p, cfg_j in ((pcfg, jcfg), (pcfg.replace(p=2), jcfg.replace(p=2)),
                         (pcfg.replace(channel_slice_list_normalized_loss=None),
                          jcfg.replace(channel_slice_list_normalized_loss=None))):
        for sw in (None, w):
            lp = pt.scot_loss(p_m, torch.from_numpy(lab), cfg_p,
                              None if sw is None else torch.from_numpy(sw))
            lj = j_loss(j_m, jnp.asarray(lab), cfg_j, None if sw is None else jnp.asarray(sw))
            np.testing.assert_allclose(float(lp), float(lj), rtol=1e-6)


# (ar_steps, output_all_steps, static channel re-attached)
ROLLOUTS = {
    "int_steps_static": (3, False, True),
    "list_steps_all_steps": ([0.25, 0.5, 1.0], True, False),
}


@pytest.mark.parametrize("name", sorted(ROLLOUTS))
def test_rollout_matches_jax(name):
    ar_steps, all_steps, static = ROLLOUTS[name]
    # num_out_channels < num_channels re-attaches the static channel.
    n_out = 2 if static else 3
    jcfg, jvars, pcfg, sd = build_pair(num_out_channels=n_out,
                                       channel_slice_list=(0, 1, n_out), **ROLLOUT_CASE)
    x, t = inputs(pcfg, seed=5)
    jm = JScOT(config=jcfg)
    run = jax.jit(lambda xx, tt: jax_rollout(
        lambda a, b: jm.apply(jvars, a, b), xx, tt, ar_steps=ar_steps,
        num_out_channels=n_out, output_all_steps=all_steps))
    y_j = np.asarray(run(jnp.asarray(x), jnp.asarray(t)))
    y_p = pt.autoregressive_rollout(port_model(pcfg, sd, "xla"), x, t, ar_steps, n_out,
                                    output_all_steps=all_steps, device="cpu")
    assert y_p.shape == y_j.shape
    np.testing.assert_allclose(y_p.numpy(), y_j, atol=ATOL, rtol=RTOL)


def test_rollout_requires_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    _, _, pcfg, sd = build_pair(**ROLLOUT_CASE)
    x, t = inputs(pcfg, seed=6)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.autoregressive_rollout(port_model(pcfg, sd, "xla"), x, t, 2, 2)
