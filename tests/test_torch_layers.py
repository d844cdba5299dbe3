"""Each layer of the PyTorch port against its flax counterpart in
``poseidon_tpu.models.layers`` (and the window geometry of
``poseidon_tpu.models.attention``), fp32 on the CPU, on the same numpy
weights and inputs. Tolerance atol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poseidon_tpu.models import attention as jattn
from poseidon_tpu.models import layers as jl

from poseidon_tpu_torch.hub import _conv_w, _linear_w, _patch_embed_w, _patch_recovery_w
from poseidon_tpu_torch.models import attention as pattn
from poseidon_tpu_torch.models import layers as pl

torch.set_num_threads(1)

ATOL = 1e-5


def _values(tree, rng, name=""):
    """Numpy values for a tree of shapes, around each parameter's init."""
    if isinstance(tree, dict):
        return {k: _values(v, rng, k) for k, v in tree.items()}
    noise = rng.normal(0.0, 0.1, size=tree.shape).astype(np.float32)
    if name in ("scale", "var"):
        return 1.0 + np.abs(noise) if name == "var" else 1.0 + noise
    return noise


def flax_vars(module, *args, seed=0):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return _values(dict(shapes), np.random.default_rng(seed))


def norm_sd(prefix, node, cond):
    if cond:
        return {f"{prefix}.weight.weight": _linear_w(node["cond_scale"]["kernel"]),
                f"{prefix}.weight.bias": node["cond_scale"]["bias"],
                f"{prefix}.bias.weight": _linear_w(node["cond_shift"]["kernel"]),
                f"{prefix}.bias.bias": node["cond_shift"]["bias"]}
    return {f"{prefix}.weight": node["LayerNorm_0"]["scale"],
            f"{prefix}.bias": node["LayerNorm_0"]["bias"]}


def load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def check(y_port, y_jax):
    y_port = y_port.detach().numpy()
    y_jax = np.asarray(y_jax)
    assert y_port.shape == y_jax.shape
    np.testing.assert_allclose(y_port, y_jax, atol=ATOL, rtol=ATOL)


def test_gelu_exact():
    (x,) = arrays(0, (4, 33))
    check(pl.gelu_exact(torch.from_numpy(x * 3)), jl.gelu_exact(jnp.asarray(x * 3)))


@pytest.mark.parametrize("cond", [True, False])
def test_norm(cond):
    x, t = arrays(1, (2, 10, 16), (2,))
    x = x * 3 + 1
    fm = jl.make_norm(cond, 16, 1e-5, jnp.float32, 0.02, "norm")
    v = flax_vars(fm, x, t)
    y_j = jax.jit(fm.apply)(v, x, t)
    pm = load(pl.make_norm(cond, 16, 1e-5, torch.float32), {
        k.split(".", 1)[1]: a for k, a in norm_sd("n", v["params"], cond).items()})
    check(pm(torch.from_numpy(x), torch.from_numpy(t)), y_j)


def test_drop_path():
    (x,) = arrays(2, (64, 3, 4))
    dp = pl.DropPath(0.25)
    assert dp.eval()(torch.from_numpy(x)) is not None
    check(dp.eval()(torch.from_numpy(x)), x)
    y = dp.train()(torch.from_numpy(x), torch.Generator().manual_seed(0)).numpy()
    kept = np.abs(y).reshape(64, -1).sum(1) > 0
    np.testing.assert_allclose(y[kept], x[kept] / 0.75, rtol=1e-6)
    assert 0 < kept.sum() < 64


@pytest.mark.parametrize("size", [8, 10])
def test_patch_embed(size):
    (x,) = arrays(3, (2, size, size, 3))
    fm = jl.PatchEmbed(patch_size=4, embed_dim=16)
    v = flax_vars(fm, x)
    p = v["params"]["projection"]
    pm = load(pl.PatchEmbed(4, 3, 16), {"projection.weight": _patch_embed_w(p["kernel"], 4),
                                        "projection.bias": p["bias"]})
    check(pm(torch.from_numpy(x)), jax.jit(fm.apply)(v, x))


def test_patch_recovery():
    (x,) = arrays(4, (2, 16, 16))
    fm = jl.PatchRecovery(patch_size=4, num_out_channels=3, grid_size=4)
    v = flax_vars(fm, x)
    p = v["params"]
    pm = load(pl.PatchRecovery(4, 16, 3, 4), {
        "projection.weight": _patch_recovery_w(p["projection"]["kernel"], 4),
        "projection.bias": p["projection_bias"],
        "mixup.weight": _conv_w(p["mixup"]["kernel"])})
    check(pm(torch.from_numpy(x)), jax.jit(fm.apply)(v, x))


@pytest.mark.parametrize("cond", [True, False])
def test_patch_merging(cond):
    x, t = arrays(5, (2, 64, 8), (2,))
    fm = jl.PatchMerging(dim=8, input_resolution=8, use_conditioning=cond)
    v = flax_vars(fm, x, t)
    p = v["params"]
    sd = {"reduction.weight": _linear_w(p["reduction"]["kernel"]), **norm_sd("norm", p["norm"], cond)}
    pm = load(pl.PatchMerging(8, 8, cond), sd)
    check(pm(torch.from_numpy(x), torch.from_numpy(t)), jax.jit(fm.apply)(v, x, t))


@pytest.mark.parametrize("cond", [True, False])
def test_patch_unmerging(cond):
    x, t = arrays(6, (2, 16, 8), (2,))
    fm = jl.PatchUnmerging(dim=8, input_resolution=4, use_conditioning=cond)
    v = flax_vars(fm, x, t)
    p = v["params"]
    sd = {"upsample.weight": _linear_w(p["expand"]["kernel"]),
          "mixup.weight": _linear_w(p["mixup"]["kernel"]), **norm_sd("norm", p["norm"], cond)}
    pm = load(pl.PatchUnmerging(8, 4, cond), sd)
    check(pm(torch.from_numpy(x), torch.from_numpy(t)), jax.jit(fm.apply)(v, x, t))


@pytest.mark.parametrize("cond", [True, False])
def test_convnext_block(cond):
    x, t = arrays(7, (2, 64, 8), (2,))
    fm = jl.ConvNeXtBlock(dim=8, use_conditioning=cond)
    v = flax_vars(fm, x, t)
    p = v["params"]
    sd = {"dwconv.weight": _conv_w(p["dwconv"]["kernel"]), "dwconv.bias": p["dwconv"]["bias"],
          "pwconv1.weight": _linear_w(p["pwconv1"]["kernel"]), "pwconv1.bias": p["pwconv1"]["bias"],
          "pwconv2.weight": _linear_w(p["pwconv2"]["kernel"]), "pwconv2.bias": p["pwconv2"]["bias"],
          "weight": p["layer_scale"], **norm_sd("norm", p["norm"], cond)}
    pm = load(pl.ConvNeXtBlock(8, cond), sd)
    check(pm(torch.from_numpy(x), torch.from_numpy(t)), jax.jit(fm.apply)(v, x, t))


def test_resnet_block_eval():
    x, t = arrays(8, (2, 64, 8), (2,))
    fm = jl.ResNetBlock(dim=8)
    v = flax_vars(fm, x, t)
    p, bs = v["params"], v["batch_stats"]
    sd = {}
    for conv in ("conv1", "conv2"):
        sd[f"{conv}.weight"] = _conv_w(p[conv]["kernel"])
        sd[f"{conv}.bias"] = p[conv]["bias"]
    for bn in ("bn1", "bn2"):
        sd.update({f"{bn}.weight": p[bn]["scale"], f"{bn}.bias": p[bn]["bias"],
                   f"{bn}.running_mean": bs[bn]["mean"], f"{bn}.running_var": bs[bn]["var"]})
    pm = load(pl.ResNetBlock(8), sd)
    check(pm(torch.from_numpy(x), torch.from_numpy(t)), jax.jit(fm.apply)(v, x, t))


@pytest.mark.parametrize("window", [2, 4, 16])
def test_window_geometry(window):
    np.testing.assert_array_equal(pattn.relative_coords_table(window),
                                  jattn.relative_coords_table(window))
    np.testing.assert_array_equal(pattn.relative_position_index(window),
                                  jattn.relative_position_index(window))
    side = 4 * window
    np.testing.assert_array_equal(pattn.shifted_window_mask(side, side, window, window // 2),
                                  jattn.shifted_window_mask(side, side, window, window // 2))
    assert pattn.shifted_window_mask(side, side, window, 0) is None
    (x,) = arrays(9, (2, side, side, 3))
    wins = pattn.window_partition(torch.from_numpy(x), window)
    check(wins, jattn.window_partition(jnp.asarray(x), window))
    check(pattn.window_reverse(wins, window, side, side), x)
