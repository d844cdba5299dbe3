"""The port's inference command line against the JAX package's, on the CPU.

Both CLIs read the same reference-format directory (written by the JAX
``save_pretrained``; weights are numpy values around the JAX init) and the
same synthetic AllenCahn file (the schema of ``tests/test_inference.py``,
copied), in modes ``eval`` (direct and AR), ``save_samples`` and
``eval_accumulation_error``: the CSV metrics agree within 1e-4 relative,
the saved samples within 1e-5. ``load_model`` reads every directory the
port's Trainer writes; the offline sweep listing and
``_resolve_model_path`` choose as the JAX CLI does."""

import csv
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poseidon_tpu.data.base as jbase
from poseidon_tpu import ScOT as JScOT
from poseidon_tpu import inference as jinference
from poseidon_tpu import make_config as jmake_config
from poseidon_tpu.hub import save_pretrained as jsave_pretrained

import poseidon_tpu_torch as pt
import poseidon_tpu_torch.data.base as pbase
from poseidon_tpu_torch import inference as pinference

from test_torch_model import _values

torch.set_num_threads(1)

RTOL_METRICS, RTOL_SAMPLES = 1e-4, 1e-5
DATASET = "reaction_diffusion.AllenCahn"


@pytest.fixture(scope="module")
def ace_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ace")
    rng = np.random.default_rng(0)
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
    """Split sizes that fit the synthetic file (4 val, 8 test rows), in both
    packages."""
    for mod in (jbase, pbase):
        orig = mod.BaseTimeDataset.post_init

        def post_init(ds, orig=orig):
            ds.N_max, ds.N_val, ds.N_test = 15000, 4, 8
            orig(ds)

        monkeypatch.setattr(mod.BaseTimeDataset, "post_init", post_init)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cfg = jmake_config("T", image_size=128, num_channels=1, num_out_channels=1,
                       channel_slice_list=(0, 1), use_conditioning=True, embed_dim=16,
                       depths=(1, 1), num_heads=(2, 2), skip_connections=(1, 0),
                       window_size=8, mlp_ratio=2.0)
    shapes = jax.eval_shape(JScOT(config=cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, 128, 128)), jnp.zeros((1,)))
    params = _values(dict(shapes), np.random.default_rng(1))["params"]
    d = str(tmp_path_factory.mktemp("ref_model"))
    jsave_pretrained(d, params, cfg)
    return d


def _argv(model_dir, ace_dir, mode, out, *extra):
    return ["--mode", mode, "--model_path", model_dir, "--data_path", ace_dir,
            "--dataset", DATASET, "--file", out, "--initial_time", "0", "--final_time", "8",
            "--batch_size", "8", *extra]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _assert_rows_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            try:
                wv = float(w[k])
            except ValueError:
                assert g[k] == w[k], k
                continue
            np.testing.assert_allclose(float(g[k]), wv, rtol=RTOL_METRICS, err_msg=k)


@pytest.mark.parametrize("mode,extra", [
    ("eval", ()), ("eval", ("--ar_steps", "2")),
    ("eval_accumulation_error", ("--time_step_size", "4"))],
    ids=["eval", "eval_ar", "accumulation_error"])
def test_csv_modes_match_jax(model_dir, ace_dir, tmp_path, mode, extra):
    jout, pout = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    jinference.main(_argv(model_dir, ace_dir, mode, jout, *extra))
    pinference.main(_argv(model_dir, ace_dir, mode, pout, *extra, "--device", "cpu"))
    rows = _rows(pout)
    assert len(rows) == (2 if mode == "eval_accumulation_error" else 1)
    _assert_rows_close(rows, _rows(jout))


def test_save_samples_match_jax(model_dir, ace_dir, tmp_path):
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jinference.main(_argv(model_dir, ace_dir, "save_samples", jout, "--ar_steps", "2"))
    pinference.main(_argv(model_dir, ace_dir, "save_samples", pout, "--ar_steps", "2",
                          "--device", "cpu"))
    for name in ("inputs", "predictions", "labels"):
        got = np.load(os.path.join(pout, f"{name}.npy"))
        want = np.load(os.path.join(jout, f"{name}.npy"))
        assert got.shape == want.shape == (4, 1, 128, 128)
        np.testing.assert_allclose(got, want, rtol=RTOL_SAMPLES, atol=1e-6, err_msg=name)


def test_load_model_reads_the_trainers_directories(model_dir, tmp_path):
    ref = pinference.load_model(model_dir, device="cpu")
    ds = [{"pixel_values": np.zeros((1, 128, 128), np.float32),
           "labels": np.zeros((1, 128, 128), np.float32), "time": np.float32(0.5)}] * 4

    class _DS(list):
        channel_slice_list = [0, 1]
        printable_channel_description = ["u"]

    trainer = pt.Trainer(ref, pt.TrainingArguments(output_dir=str(tmp_path), train_batch_size=2,
                                                   num_workers=1, report_to="none",
                                                   learning_rate=0.0),
                         train_dataset=_DS(ds), device="cpu")
    trainer.train()
    trainer.save_model(str(tmp_path))
    want = ref.state_dict()
    for path in (str(tmp_path), str(tmp_path / "checkpoint-0")):
        got = pinference.load_model(path, device="cpu").state_dict()
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want), path
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pinference.load_model(model_dir)


def test_resolve_model_path_matches_jax(tmp_path, capsys):
    run = tmp_path / "runA"
    for d in ("checkpoint-1000", "checkpoint-2000", "checkpoint-0-step3", "profile"):
        (run / d).mkdir(parents=True)
    for fn in (pinference._resolve_model_path, jinference._resolve_model_path):
        assert fn(str(run)).endswith("checkpoint-2000")
        assert "WARNING" in capsys.readouterr().out
    (run / "best").mkdir()
    assert pinference._resolve_model_path(str(run)).endswith("best")
    (run / "model").mkdir()
    assert pinference._resolve_model_path(str(run)) == str(run)
    assert pinference._resolve_model_path(str(tmp_path / "runA" / "profile")) is None


def test_offline_sweep_listing_matches_jax(tmp_path):
    import argparse

    for name in ("r2", "r1"):
        (tmp_path / "proj" / "sw" / name).mkdir(parents=True)
    params = argparse.Namespace(run_names=[], wandb_entity=None, base_checkpoint_dir=str(tmp_path),
                                wandb_project="proj", sweep_id="sw", dataset=DATASET)
    for p in (params, argparse.Namespace(**dict(vars(params), run_names=["x"]))):
        got = [(r.name, r.config) for r in pinference._sweep_runs(p)]
        want = [(r.name, r.config) for r in jinference._sweep_runs(p)]
        assert got == want
    assert [r.name for r in pinference._sweep_runs(params)] == ["r1", "r2"]


def test_eval_sweep_walks_the_runs(model_dir, ace_dir, tmp_path):
    import shutil

    for name in ("a", "b"):
        shutil.copytree(model_dir, tmp_path / "proj" / "sw" / name / "best")
    out = str(tmp_path / "sweep.csv")
    pinference.main(["--mode", "eval_sweep", "--data_path", ace_dir, "--dataset", DATASET,
                     "--file", out, "--initial_time", "0", "--final_time", "8",
                     "--batch_size", "8", "--base_checkpoint_dir", str(tmp_path),
                     "--wandb_project", "proj", "--sweep_id", "sw", "--device", "cpu"])
    rows = _rows(out)
    assert [os.path.basename(os.path.dirname(r["model"])) for r in rows] == ["a", "b"]
    assert rows[0]["loss"] == rows[1]["loss"]
