"""The port's config against the JAX package's: same fields, defaults,
named sizes, and ``from_dict`` round trips of what the JAX ``to_dict``
writes."""

import json

import pytest

from poseidon_tpu import config as jconfig

from poseidon_tpu_torch import config as pconfig


def test_same_fields_and_defaults():
    assert pconfig.ScOTConfig().to_dict() == jconfig.ScOTConfig().to_dict()


def test_model_map_equal():
    assert pconfig.MODEL_MAP == jconfig.MODEL_MAP


@pytest.mark.parametrize("size", sorted(jconfig.MODEL_MAP))
def test_make_config_matches(size):
    kw = dict(image_size=128, num_channels=4, num_out_channels=4,
              channel_slice_list=(0, 1, 3, 4), use_conditioning=True)
    j = jconfig.make_config(size, **kw)
    p = pconfig.make_config(size, **kw)
    assert p.to_dict() == j.to_dict()
    assert p.mlp_min_win_tile == (128 if size == "L" else None)
    for i in range(p.num_stages):
        for shifted in (False, True):
            assert p.stage_window_and_shift(i, shifted) == j.stage_window_and_shift(i, shifted)
    assert (p.hidden_size, p.grid_size) == (j.hidden_size, j.grid_size)


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(attention_impl="pallas", score_dtype="bfloat16", scan_blocks=True),
    dict(use_conditioning=False, learn_residual=True, residual_model="resnet", p=2),
])
def test_from_dict_roundtrip_of_jax_to_dict(overrides):
    j = jconfig.make_config("B", num_channels=4, num_out_channels=4, **overrides)
    d = json.loads(json.dumps(j.to_dict()))  # lists, as config.json holds them
    d["model_type"] = "swinv2"  # save_pretrained's extra key
    p = pconfig.ScOTConfig.from_dict(d)
    assert p.to_dict() == j.to_dict()
    assert pconfig.ScOTConfig.from_json(p.to_json()) == p


def test_validation():
    with pytest.raises(ValueError):
        pconfig.ScOTConfig(residual_model="unet")
    with pytest.raises(ValueError):
        pconfig.ScOTConfig(attention_impl="triton")
    assert not pconfig.ScOTConfig(use_conditioning=False, learn_residual=True).learn_residual
