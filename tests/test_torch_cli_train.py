"""The port's train command line on the CPU, against the JAX package's:

- the same JSON config writes the JAX CLI's run layout
  (``<ckpt>/<project>/<run>``: ``logs.jsonl``, ``checkpoint-*``, ``best/``,
  ``model/``, ``config.json``) with the same model config;
- ``--finetune_from`` without ``--replace_embedding_recovery`` takes the
  checkpoint's own config and fails loudly on a channel mismatch; with it,
  the model is shaped by the dataset and the embedding and recovery are
  re-initialised (``tests/test_finetune_cli.py``'s checks of the JAX CLI,
  its fixtures' schemas copied);
- ``--resume_training`` ends on the weights of the uninterrupted run;
- the post-training test protocol logs its direct and AR metrics;
- ``load_config`` reads JSON, a JSON string and YAML (``1e-6`` as a float).
"""

import json
import os
import sys

import h5py
import numpy as np
import pytest
import torch

import poseidon_tpu.data.base as jbase
from poseidon_tpu import train as jtrain

import poseidon_tpu_torch as pt
import poseidon_tpu_torch.data.base as pbase
from poseidon_tpu_torch import train as ptrain

torch.set_num_threads(1)

TINY = {
    "dataset": "reaction_diffusion.AllenCahn",
    "num_trajectories": 2,
    "patch_size": 4, "embed_dim": 16, "depths": [1, 1], "num_heads": [2, 2],
    "skip_connections": [1, 0], "window_size": 8, "mlp_ratio": 2.0,
    "num_epochs": 1, "lr": 1e-4, "lr_embedding_recovery": 1e-3,
    "lr_time_embedding": 1e-3, "weight_decay": 1e-6, "batch_size": 1,
}


@pytest.fixture(scope="module")
def ace_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ace_ft")
    rng = np.random.default_rng(3)
    with h5py.File(d / "ACE.nc", "w") as f:
        ds = f.create_dataset("solution", shape=(15000, 20, 128, 128), dtype="f4",
                              chunks=(1, 1, 128, 128))
        for i in list(range(4)) + list(range(14988, 15000)):
            base = rng.normal(size=(128, 128)).astype("f4")
            for t in range(20):
                ds[i, t] = base * np.exp(-0.05 * t)
    return str(d)


@pytest.fixture(autouse=True)
def small_splits(monkeypatch):
    # The runs are named, which starts W&B where it is installed: block it.
    monkeypatch.setitem(sys.modules, "wandb", None)
    for mod in (jbase, pbase):
        orig = mod.BaseTimeDataset.post_init

        def post_init(ds, orig=orig):
            ds.N_max, ds.N_val, ds.N_test = 15000, 4, 8
            orig(ds)

        monkeypatch.setattr(mod.BaseTimeDataset, "post_init", post_init)


class _DS:
    resolution = 128
    input_dim = 1
    output_dim = 1
    channel_slice_list = [0, 1]


class _DS2:
    resolution = 128
    input_dim = 2
    output_dim = 2
    channel_slice_list = [0, 1, 2]


def _checkpoint(tmp_path_factory, name, cfg):
    d = str(tmp_path_factory.mktemp(name))
    pt.save_pretrained(pt.build_model(cfg, device="cpu", seed=1), d)
    return d


@pytest.fixture(scope="module")
def ckpt_same_channels(tmp_path_factory):
    """The dataset's channels, but embed_dim 24 (the config says 16)."""
    return _checkpoint(tmp_path_factory, "ckpt24",
                       ptrain.build_model_config(dict(TINY, embed_dim=24), _DS(), True))


@pytest.fixture(scope="module")
def ckpt_two_channels(tmp_path_factory):
    """2 channels in and out: AllenCahn has 1."""
    return _checkpoint(tmp_path_factory, "ckpt2ch", ptrain.build_model_config(TINY, _DS2(), True))


def _argv(ace_dir, out, run, config=TINY, *extra):
    return ["--config", json.dumps(config), "--json_config", "--data_path", ace_dir,
            "--checkpoint_path", str(out), "--wandb_project_name", "proj",
            "--wandb_run_name", run, *extra]


def _port(ace_dir, out, run, config=TINY, *extra):
    return ptrain.main(_argv(ace_dir, out, run, config, "--device", "cpu", *extra))


def test_run_layout_and_model_config_match_jax(ace_dir, tmp_path):
    jtrain.main(_argv(ace_dir, tmp_path / "jax", "r", TINY, "--train_small_time_transition"))
    trainer = _port(ace_dir, tmp_path / "port", "r", TINY, "--train_small_time_transition")
    jdir, pdir = tmp_path / "jax" / "proj" / "r", tmp_path / "port" / "proj" / "r"
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == [
        "best", "checkpoint-0", "config.json", "logs.jsonl", "model"]
    assert json.loads((pdir / "config.json").read_text()) == \
        json.loads((jdir / "config.json").read_text())
    assert trainer.config.num_channels == 1 and trainer.config.use_conditioning
    logs = [json.loads(line) for line in open(pdir / "logs.jsonl")]
    assert any("eval_loss" in r for r in logs)
    assert all(np.isfinite(r["loss"]) for r in logs if "loss" in r)


def test_test_protocol_and_gradient_checkpointing(ace_dir, tmp_path):
    trainer = _port(ace_dir, tmp_path, "p", dict(TINY, gradient_checkpointing=True))
    assert trainer.args.gradient_checkpointing and trainer.model.remat is True
    last = [json.loads(line) for line in open(tmp_path / "proj" / "p" / "logs.jsonl")][-1]
    assert np.isfinite(last["test/loss"]) and np.isfinite(last["test/ar/loss"])


def test_no_flag_uses_checkpoint_config(ace_dir, ckpt_same_channels, tmp_path):
    trainer = _port(ace_dir, tmp_path, "ft", TINY, "--train_small_time_transition",
                    "--finetune_from", ckpt_same_channels)
    assert trainer.config.embed_dim == 24
    assert trainer.config.num_channels == 1


def test_no_flag_channel_mismatch_fails_loudly(ace_dir, ckpt_two_channels, tmp_path):
    with pytest.raises(ValueError, match="replace_embedding_recovery"):
        _port(ace_dir, tmp_path, "ft", TINY, "--train_small_time_transition",
              "--finetune_from", ckpt_two_channels)


def test_flag_replaces_embedding_recovery(ace_dir, ckpt_two_channels, tmp_path, capsys):
    trainer = _port(ace_dir, tmp_path, "ft", TINY, "--train_small_time_transition",
                    "--finetune_from", ckpt_two_channels, "--replace_embedding_recovery")
    assert trainer.config.num_channels == 1
    assert trainer.config.num_out_channels == 1
    assert trainer.config.embed_dim == 16
    assert "Re-initialized 4 mismatched tensors" in capsys.readouterr().out
    # Fine-tuning gives the embedding and time embedding groups of their own.
    labels = {g["label"] for g in trainer.optimizer.param_groups}
    assert {"embeddings", "time_embedding"} <= labels


def test_resume_training_ends_on_the_uninterrupted_weights(ace_dir, tmp_path):
    config = dict(TINY, lr_scheduler="constant", num_epochs=2, lr=1e-3)
    _port(ace_dir, tmp_path, "full", config, "--train_small_time_transition")
    _port(ace_dir, tmp_path, "cut", dict(config, num_epochs=1), "--train_small_time_transition")
    resumed = _port(ace_dir, tmp_path, "cut", config, "--train_small_time_transition",
                    "--resume_training")
    assert resumed.step == 2 * resumed._steps_per_epoch()
    full = torch.load(tmp_path / "proj" / "full" / "model" / "state_dict.pt")
    cut = torch.load(tmp_path / "proj" / "cut" / "model" / "state_dict.pt")
    assert full.keys() == cut.keys()
    for k in full:
        assert torch.equal(full[k], cut[k]), k


def test_load_config_formats(tmp_path):
    import argparse

    yaml_path = tmp_path / "run.yaml"
    yaml_path.write_text("lr: 1e-6\nwandb_nested:\n  value: 3\nname: x\n")
    json_path = tmp_path / "run.json"
    json_path.write_text(json.dumps({"lr": 1e-6}))
    for mod in (ptrain, jtrain):
        ns = argparse.Namespace(json_config=False, config=str(yaml_path))
        assert mod.load_config(ns) == {"lr": 1e-6, "wandb_nested": 3, "name": "x"}
        ns = argparse.Namespace(json_config=False, config=str(json_path))
        assert mod.load_config(ns) == {"lr": 1e-6}
        ns = argparse.Namespace(json_config=True, config='{"a": 1}')
        assert mod.load_config(ns) == {"a": 1}
