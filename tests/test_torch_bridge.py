"""The port's weight bridge: ``from_jax_params`` equals the JAX package's
``export_torch_state_dict`` key by key (unrolled and ``scan_blocks``
params, resnet ``batch_stats``), loads into the port with ``strict=True``,
and ``from_pretrained`` loads a directory written by the JAX
``save_pretrained``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poseidon_tpu import ScOT as JScOT
from poseidon_tpu import make_config as jmake_config
from poseidon_tpu.hub import export_torch_state_dict, save_pretrained

import poseidon_tpu_torch as pt

torch.set_num_threads(1)

TOY = dict(image_size=32, patch_size=4, num_channels=3, num_out_channels=2,
           embed_dim=16, depths=(2, 2, 2), num_heads=(2, 2, 2),
           skip_connections=(1, 1, 0), window_size=4, mlp_ratio=2.0,
           channel_slice_list=(0, 1, 2), use_conditioning=True)


def jax_variables(seed=0, use_mask_token=False, scale=1.0, **overrides):
    jcfg = jmake_config("T", **dict(TOY, **overrides))
    x0 = jnp.zeros((1, jcfg.num_channels, jcfg.image_size, jcfg.image_size))
    shapes = jax.eval_shape(JScOT(config=jcfg, use_mask_token=use_mask_token).init,
                            jax.random.PRNGKey(0), x0, jnp.zeros((1,)))
    rng = np.random.default_rng(seed)
    values = jax.tree.map(lambda s: (scale * rng.normal(size=s.shape)).astype(np.float32), shapes)
    return jcfg, dict(values)


def assert_same(sd_port, sd_jax):
    assert set(sd_port) == set(sd_jax)
    for k, v in sd_jax.items():
        assert isinstance(sd_port[k], torch.Tensor) and sd_port[k].dtype == torch.float32, k
        np.testing.assert_array_equal(sd_port[k].numpy(), v, err_msg=k)


CASES = {
    "conditioned": dict(),
    "unconditioned_abs_embeddings": dict(use_conditioning=False, use_absolute_embeddings=True),
    "no_qkv_bias": dict(qkv_bias=False),
    "scan_blocks": dict(scan_blocks=True),
    "scan_blocks_odd_depth": dict(scan_blocks=True, depths=(1, 2, 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_export_torch_state_dict(case):
    jcfg, v = jax_variables(**CASES[case])
    pcfg = pt.ScOTConfig.from_dict(jcfg.to_dict())
    sd = pt.from_jax_params(v["params"], pcfg)
    assert_same(sd, export_torch_state_dict(v["params"], jcfg))
    pt.ScOT(pcfg).load_state_dict(sd, strict=True)


def test_resnet_batch_stats():
    jcfg, v = jax_variables(residual_model="resnet")
    pcfg = pt.ScOTConfig.from_dict(jcfg.to_dict())
    sd = pt.from_jax_params(v["params"], pcfg, v["batch_stats"])
    assert_same(sd, export_torch_state_dict(v["params"], jcfg, v["batch_stats"]))
    assert any(k.endswith("bn1.running_var") for k in sd)
    pt.ScOT(pcfg).load_state_dict(sd, strict=True)


def test_mask_token():
    jcfg, v = jax_variables(use_mask_token=True)
    pcfg = pt.ScOTConfig.from_dict(jcfg.to_dict())
    sd = pt.from_jax_params(v["params"], pcfg)
    assert_same(sd, export_torch_state_dict(v["params"], jcfg))
    pt.ScOT(pcfg, use_mask_token=True).load_state_dict(sd, strict=True)


def test_scanned_equals_unrolled_weights():
    jcfg, v = jax_variables(scan_blocks=True)
    from poseidon_tpu.hub import unroll_scanned_params

    pcfg = pt.ScOTConfig.from_dict(jcfg.to_dict())
    a = pt.from_jax_params(v["params"], pcfg)
    b = pt.from_jax_params(unroll_scanned_params(v["params"], jcfg), pcfg.replace(scan_blocks=False))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_from_pretrained_loads_jax_save_pretrained(tmp_path):
    jcfg, v = jax_variables(seed=1, scale=0.05)
    save_pretrained(str(tmp_path), v["params"], jcfg)
    model = pt.from_pretrained(str(tmp_path), device="cpu")
    assert model.config.to_dict() == jcfg.to_dict()
    sd = export_torch_state_dict(v["params"], jcfg)
    got = model.state_dict()
    for k, val in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), val, err_msg=k)
    # The loaded model runs and matches the JAX model on the same input.
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 3, 32, 32)).astype(np.float32)
    t = np.array([0.4], np.float32)
    with torch.no_grad():
        y_p = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    y_j = np.asarray(jax.jit(JScOT(config=jcfg).apply)({"params": v["params"]}, x, t))
    np.testing.assert_allclose(y_p, y_j, atol=2e-5, rtol=1e-4)


def test_from_pretrained_pytorch_bin(tmp_path):
    jcfg, v = jax_variables(seed=3)
    save_pretrained(str(tmp_path), v["params"], jcfg)
    sd = pt.hub.load_state_dict(str(tmp_path))
    (tmp_path / "model.safetensors").unlink()
    torch.save(sd, tmp_path / "pytorch_model.bin")
    model = pt.from_pretrained(str(tmp_path), device="cpu", dtype=torch.bfloat16)
    assert model.dtype == torch.bfloat16
    for k, val in sd.items():
        assert torch.equal(model.state_dict()[k], val), k


def test_from_pretrained_requires_device_or_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    jcfg, v = jax_variables()
    save_pretrained(str(tmp_path), v["params"], jcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.from_pretrained(str(tmp_path))
