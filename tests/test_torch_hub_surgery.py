"""Checkpoint directories between the two packages, and the fine-tune
surgery:

- a directory written by the JAX ``save_pretrained`` loads into the port,
  and one written by the port's ``save_pretrained`` (BatchNorm running
  statistics included) loads into the JAX ``from_pretrained``; the two
  forwards agree within relative L2 1e-5 (fp32);
- ``from_pretrained(dir, config=...)`` onto other channels replaces the
  same tensors in both packages (the JAX list of Flax paths turned into
  reference names through ``export_torch_state_dict``), keeps every other
  tensor equal to the checkpoint's, and raises without
  ``ignore_mismatched_sizes``;
- the port's safetensors reader and writer agree with the ``safetensors``
  package both ways;
- a path that is neither a directory nor fetchable raises a clear error
  (the Hub import blocked: nothing is downloaded);
- the parameter counts equal the JAX package's."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu import ScOT as JScOT
from poseidon_tpu import make_config as jmake_config
from poseidon_tpu.hub import export_torch_state_dict
from poseidon_tpu.hub import from_pretrained as jfrom_pretrained
from poseidon_tpu.hub import save_pretrained as jsave_pretrained
from poseidon_tpu.utils.params import get_num_parameters as jcount
from poseidon_tpu.utils.params import get_num_parameters_no_embed as jcount_no_embed

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.utils import params as pparams
from poseidon_tpu_torch.utils import safetensors_io

from test_torch_model import _values

torch.set_num_threads(1)

TOL = 1e-5
TOY = dict(image_size=32, patch_size=4, num_channels=3, num_out_channels=2, embed_dim=16,
           depths=(2, 2), num_heads=(2, 2), skip_connections=(1, 1), window_size=4,
           mlp_ratio=2.0, channel_slice_list=(0, 1, 2), use_conditioning=True)
EMBED_RECOVERY = {"embeddings.patch_embeddings.projection.weight",
                  "patch_recovery.projection.weight", "patch_recovery.projection.bias",
                  "patch_recovery.mixup.weight"}


def _jax_vars(jcfg, seed=0):
    x0 = jnp.zeros((1, jcfg.num_channels, jcfg.image_size, jcfg.image_size))
    shapes = jax.eval_shape(JScOT(config=jcfg).init, jax.random.PRNGKey(0), x0, jnp.zeros((1,)))
    return _values(dict(shapes), np.random.default_rng(seed))


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, cfg.num_channels, 32, 32)).astype(np.float32),
            rng.uniform(0.1, 1.0, size=2).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _jax_forward(jcfg, variables, x, t):
    return np.asarray(jax.jit(JScOT(config=jcfg).apply)(variables, x, t))


def test_jax_directory_loads_into_port(tmp_path):
    jcfg = jmake_config("T", **TOY)
    jvars = _jax_vars(jcfg)
    jsave_pretrained(str(tmp_path), jvars["params"], jcfg)
    model = pt.from_pretrained(str(tmp_path), device="cpu")
    x, t = _inputs(jcfg)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert _rel(got, _jax_forward(jcfg, {"params": jvars["params"]}, x, t)) <= TOL


@pytest.mark.parametrize("residual", ["convnext", "resnet"])
def test_port_directory_loads_into_jax(tmp_path, residual):
    jcfg = jmake_config("T", **dict(TOY, residual_model=residual))
    jvars = _jax_vars(jcfg, seed=2)
    pcfg = pt.ScOTConfig.from_dict(jcfg.to_dict())
    model = pt.ScOT(pcfg)
    model.load_state_dict(pt.from_jax_params(jvars["params"], pcfg, jvars.get("batch_stats")),
                          strict=True)
    pt.save_pretrained(model, str(tmp_path))
    cfg_json = json.loads((tmp_path / "config.json").read_text())
    assert cfg_json["model_type"] == "swinv2"
    _, variables, replaced = jfrom_pretrained(str(tmp_path))
    assert replaced == []
    x, t = _inputs(jcfg, seed=3)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert _rel(got, _jax_forward(jcfg, variables, x, t)) <= TOL
    if residual == "resnet":  # the running statistics made the round trip
        stats = jax.tree.leaves(variables["batch_stats"])
        assert len(stats) == 8 and not any(np.allclose(s, 0.0) for s in stats[::2])


def _jax_replaced_names(new_params, replaced, cfg):
    """Reference names of the Flax paths in ``replaced``: ones at those
    leaves, zeros elsewhere, laid out by ``export_torch_state_dict``."""
    def mark(tree, path=()):
        if isinstance(tree, dict):
            return {k: mark(v, path + (k,)) for k, v in tree.items()}
        hit = "/".join(path) in replaced
        return np.full(np.shape(tree), 1.0 if hit else 0.0, np.float32)

    sd = export_torch_state_dict(mark(jax.tree.map(np.asarray, dict(new_params))), cfg)
    return {k for k, v in sd.items() if v.size and np.all(v == 1.0)}


def test_surgery_replaces_the_same_tensors_as_jax(tmp_path):
    jcfg = jmake_config("T", **TOY)
    jvars = _jax_vars(jcfg, seed=4)
    jsave_pretrained(str(tmp_path), jvars["params"], jcfg)
    ckpt = pt.hub.load_state_dict(str(tmp_path))
    new = dict(TOY, num_channels=1, num_out_channels=1, channel_slice_list=(0, 1))
    jnew = jmake_config("T", **new)
    _, jv, jreplaced = jfrom_pretrained(str(tmp_path), config=jnew, ignore_mismatched_sizes=True)
    want = _jax_replaced_names(jv["params"], jreplaced, jnew)
    assert want == EMBED_RECOVERY

    pnew = pt.ScOTConfig.from_dict(jnew.to_dict())
    model, info = pt.from_pretrained(str(tmp_path), config=pnew, ignore_mismatched_sizes=True,
                                     device="cpu", output_loading_info=True)
    assert set(info["replaced"]) == want
    sd = model.state_dict()
    jsd = export_torch_state_dict(jax.tree.map(np.asarray, dict(jv["params"])), jnew)
    for k, v in sd.items():
        if k in want:
            assert v.shape != ckpt[k].shape, k
        else:
            assert torch.equal(v, ckpt[k]), k
            np.testing.assert_array_equal(jsd[k], ckpt[k].numpy(), err_msg=k)
    x, t = _inputs(pnew)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t))
    assert out.shape == (2, 1, 32, 32) and torch.isfinite(out).all()

    with pytest.raises(ValueError, match="ignore_mismatched_sizes"):
        pt.from_pretrained(str(tmp_path), config=pnew, device="cpu")
    with pytest.raises(ValueError, match="ignore_mismatched_sizes"):
        jfrom_pretrained(str(tmp_path), config=jnew)
    # With the checkpoint's own config nothing is replaced.
    same, info = pt.from_pretrained(str(tmp_path), config=pt.ScOTConfig.from_dict(jcfg.to_dict()),
                                    device="cpu", output_loading_info=True)
    assert info == {"replaced": []}


def test_surgery_without_conditioning_reinitialises_the_norms(tmp_path):
    # A time-conditioned checkpoint onto a model without conditioning (a
    # steady dataset): the conditional norms' tensors do not exist in the
    # new model, its plain norms do not exist in the checkpoint; the plain
    # norms keep their init and are listed, as the reference's loader
    # initialises keys the checkpoint lacks. (The JAX converter raises a
    # KeyError here.)
    cfg = pt.make_config("T", **TOY)
    pt.save_pretrained(pt.build_model(cfg, device="cpu", seed=5), str(tmp_path))
    new = cfg.replace(num_channels=1, num_out_channels=1, channel_slice_list_normalized_loss=(0, 1),
                      use_conditioning=False)
    model, info = pt.from_pretrained(str(tmp_path), config=new, ignore_mismatched_sizes=True,
                                     device="cpu", output_loading_info=True)
    ckpt = pt.hub.load_state_dict(str(tmp_path))
    replaced = set(info["replaced"])
    absent = {k for k in model.state_dict() if k not in ckpt}
    assert absent and all(".norm." in k or "layernorm" in k for k in absent)
    assert replaced == absent | EMBED_RECOVERY


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=g),
               "b": torch.randn(7, generator=g).to(torch.bfloat16),
               "c.idx": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "d.half": torch.randn(2, 2, 2, generator=g).half(),
               "e.scalar": torch.tensor(3.5),
               "f.empty": torch.zeros(0, 4),
               "g.flag": torch.tensor([True, False, True])}
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    safetensors_io.save_file(tensors, ours, metadata={"format": "pt"})
    save_file(tensors, theirs, metadata={"format": "pt"})
    for got in (load_file(ours), safetensors_io.load_file(theirs), safetensors_io.load_file(ours)):
        assert got.keys() == tensors.keys()
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert torch.equal(got[k], v), k


def test_resolve_model_path_error_is_clear(tmp_path, monkeypatch):
    assert pt.hub.resolve_model_path(str(tmp_path)) == str(tmp_path)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(FileNotFoundError, match="not a local directory"):
        pt.hub.resolve_model_path(str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError, match="not a local directory"):
        pt.from_pretrained(str(tmp_path / "missing"), device="cpu")
    assert pt.hub.push_to_hub("owner/name", str(tmp_path)) is False


def test_parameter_counts_match_jax():
    jcfg = jmake_config("T", **TOY)
    jvars = _jax_vars(jcfg)
    model = pt.ScOT(pt.ScOTConfig.from_dict(jcfg.to_dict()))
    assert pparams.get_num_parameters(model) == jcount(jvars["params"])
    assert pparams.get_num_parameters_no_embed(model) == jcount_no_embed(jvars["params"])
