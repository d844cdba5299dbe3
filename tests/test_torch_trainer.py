"""The port's Trainer (``poseidon_tpu_torch.Trainer``) against the JAX
package's, on the CPU, at the toy size of ``tests/test_trainer.py`` (batch
8, which the conftest's 8-device mesh needs), fp32, dropout 0, the same
weights (numpy values around the JAX init, carried over by
``from_jax_params``) and the same synthetic dataset:

- evaluation metrics, and AR predictions with their ``ar_step_{i}/``
  battery, on the same weights: rtol 1e-4 (the model tolerance of
  ``tests/test_torch_model.py``);
- the per-step losses in ``logs.jsonl`` over two epochs of training, and
  the epoch losses and evaluation losses: rtol 2e-4 (the gate of
  ``tests/test_torch_train_step.py``);
- a run resumed from a mid-epoch checkpoint logs the losses of the
  uninterrupted run and ends on its weights, bit for bit (dropout and
  drop-path on, the masks drawn from (seed, step));
- keep-best, ``save_total_limit``, early stopping and
  ``load_best_model_at_end`` behave as in ``tests/test_trainer.py``, and a
  checkpoint whose write did not finish is skipped; ``save_model``, the
  profile window and the wandb fallback write what they should.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu import ScOT as JScOT
from poseidon_tpu.metrics import ChannelGroupMetrics as JMetrics
from poseidon_tpu.training import Trainer as JTrainer
from poseidon_tpu.training import TrainingArguments as JArgs

import poseidon_tpu_torch as pt

from test_torch_model import _values
from test_trainer import SyntheticTimeDataset, tiny_cfg

torch.set_num_threads(1)

RTOL_FWD, RTOL_STEP = 1e-4, 2e-4


def _args(cls, out, **kw):
    base = dict(output_dir=str(out), train_batch_size=8, eval_batch_size=8, num_train_epochs=2,
                learning_rate=1e-3, weight_decay=1e-6, max_grad_norm=5.0,
                compute_dtype="float32", logging_steps=1, num_workers=2)
    base.update(kw)
    return cls(**base)


def _jax_pair(seed=0, **overrides):
    jcfg = tiny_cfg(**overrides)
    x0 = jnp.zeros((1, 2, 16, 16))
    shapes = jax.eval_shape(JScOT(config=jcfg).init, jax.random.PRNGKey(0), x0, jnp.zeros((1,)))
    jvars = _values(dict(shapes), np.random.default_rng(seed))
    pcfg = pt.ScOTConfig.from_dict(jcfg.to_dict())
    return jcfg, jvars, pcfg, pt.from_jax_params(jvars["params"], pcfg)


def _port_trainer(out, pcfg, sd, ds, eval_ds=None, **kw):
    model = pt.ScOT(pcfg)
    model.load_state_dict(sd, strict=True)
    metrics = pt.ChannelGroupMetrics(ds.channel_slice_list, ds.printable_channel_description)
    return pt.Trainer(model, _args(pt.TrainingArguments, out, **kw), train_dataset=ds,
                      eval_dataset=eval_ds, compute_metrics=metrics, device="cpu")


def _log(out):
    with open(os.path.join(out, "logs.jsonl")) as f:
        return [json.loads(line) for line in f]


def _close(got, want, rtol, what):
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=f"{what}: {k}")


def test_evaluate_predict_and_training_match_jax(tmp_path):
    jcfg, jvars, pcfg, sd = _jax_pair()
    ds = SyntheticTimeDataset(n=36)  # 36 = 4 batches of 8 + a padded one
    jmetrics = JMetrics(ds.channel_slice_list, ds.printable_channel_description)
    jt = JTrainer(JScOT(config=jcfg), _args(JArgs, tmp_path / "jax"), train_dataset=ds,
                  eval_dataset=ds, compute_metrics=jmetrics, variables=jvars)
    ptr = _port_trainer(tmp_path / "port", pcfg, sd, ds, ds)

    _close(ptr.evaluate(), jt.evaluate(), RTOL_FWD, "evaluate")
    # A JAX Trainer of its own for the AR predictions: the JAX Trainer's jit
    # cache reuses the trace of its first evaluation for a later one whose
    # AR settings differ (the trace is cached on the bound method).
    jt_ar = JTrainer(JScOT(config=jcfg), _args(JArgs, tmp_path / "jax_ar"), eval_dataset=ds,
                     compute_metrics=jmetrics, variables=jvars)
    for t in (jt_ar, ptr):
        t.set_ar_steps(2, output_all_steps=True)
    got = ptr.predict(ds, metric_key_prefix="t/")
    want = jt_ar.predict(ds, metric_key_prefix="t/")
    assert got.predictions.shape == want.predictions.shape == (36, 2, 2, 16, 16)
    np.testing.assert_allclose(got.predictions, np.asarray(want.predictions), atol=2e-5,
                               rtol=RTOL_FWD)
    np.testing.assert_array_equal(got.label_ids, np.asarray(want.label_ids))
    assert any(k.startswith("t/ar_step_1/") for k in got.metrics)
    _close(got.metrics, want.metrics, RTOL_FWD, "predict")
    ptr.set_ar_steps(None)

    hist_j, hist_p = jt.train(), ptr.train()
    steps_j = [r for r in _log(tmp_path / "jax") if "loss" in r and "step" in r]
    steps_p = [r for r in _log(tmp_path / "port") if "loss" in r and "step" in r]
    assert [r["step"] for r in steps_p] == [r["step"] for r in steps_j] == list(range(1, 9))
    np.testing.assert_allclose([r["loss"] for r in steps_p], [r["loss"] for r in steps_j],
                               rtol=RTOL_STEP)
    for hp, hj in zip(hist_p, hist_j):
        np.testing.assert_allclose([hp["train_loss"], hp["eval_loss"]],
                                   [hj["train_loss"], hj["eval_loss"]], rtol=RTOL_STEP)


def test_save_model_profile_and_wandb_fallback(tmp_path):
    """``report_to="wandb"`` without wandb logs to logs.jsonl, as the JAX
    Trainer does; the profile window writes a trace into output_dir/profile;
    ``save_model`` writes weights and config that load into a new model."""
    import importlib.util
    _, _, pcfg, sd = _jax_pair(seed=5)
    ds = SyntheticTimeDataset()
    t = _port_trainer(tmp_path, pcfg, sd, ds, num_train_epochs=1, report_to="wandb",
                      profile_step_start=1, profile_step_stop=2)
    t.train()
    t.close()
    if importlib.util.find_spec("wandb") is None:
        assert any("loss" in r for r in _log(tmp_path))
    assert os.listdir(tmp_path / "profile")
    t.save_model(str(tmp_path / "final"))
    with open(tmp_path / "final" / "config.json") as f:
        cfg = pt.ScOTConfig.from_json(f.read())
    model = pt.ScOT(cfg)
    model.load_state_dict(torch.load(tmp_path / "final" / "model" / "state_dict.pt",
                                     weights_only=True), strict=True)
    for k, v in t.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_mid_epoch_resume_is_bitwise(tmp_path):
    _, _, pcfg, sd = _jax_pair(seed=1)
    pcfg = pcfg.replace(hidden_dropout_prob=0.1, drop_path_rate=0.2)
    ds = SyntheticTimeDataset()  # 32 samples: 4 steps an epoch
    kw = dict(save_steps=2, save_total_limit=10)
    full = _port_trainer(tmp_path / "full", pcfg, sd, ds, **kw)
    full.train()
    full.close()
    ckpts = sorted(os.listdir(tmp_path / "full"))
    assert "checkpoint-1-step2" in ckpts and "checkpoint-0-step2" in ckpts, ckpts
    # An interrupted run: its output directory holds what the full run had
    # written when epoch 1's mid-epoch checkpoint was saved.
    os.makedirs(tmp_path / "resumed")
    shutil.copytree(tmp_path / "full" / "checkpoint-1-step2",
                    tmp_path / "resumed" / "checkpoint-1-step2")
    _, _, _, other = _jax_pair(seed=2)  # different starting weights: all restored
    resumed = _port_trainer(tmp_path / "resumed", pcfg, other, ds, resume_from_checkpoint=True,
                            **kw)
    hist = resumed.train()
    resumed.close()
    assert [h["epoch"] for h in hist] == [1] and resumed.step == full.step == 8
    want = {r["step"]: r for r in _log(tmp_path / "full") if "step" in r}
    got = {r["step"]: r for r in _log(tmp_path / "resumed") if "step" in r}
    assert sorted(got) == [7, 8]
    for s in got:
        assert (got[s]["loss"], got[s]["grad_norm"]) == (want[s]["loss"], want[s]["grad_norm"])
    assert hist[0]["train_loss"] == [r for r in _log(tmp_path / "full")
                                     if r.get("epoch") == 1 and "train_loss" in r][0][
        "train_loss"]
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_keep_best_limit_early_stopping_and_load_best(tmp_path):
    _, _, pcfg, sd = _jax_pair(seed=3)
    ds = SyntheticTimeDataset()
    t = _port_trainer(tmp_path / "a", pcfg, sd, ds, ds, num_train_epochs=3)
    hist = t.train()
    assert len(hist) == 3 and "eval_mean_relative_l1_error" in hist[-1]
    names = sorted(os.listdir(tmp_path / "a"))
    assert "best" in names and sum(n.startswith("checkpoint-") for n in names) == 1
    # load_best_model_at_end: the weights are those of best/.
    best = torch.load(tmp_path / "a" / "best" / "state.pt", weights_only=True)["model"]
    assert all(torch.equal(t.model.state_dict()[k], v) for k, v in best.items())
    # lr 0: no improvement after the first evaluation; patience 1 stops.
    t = _port_trainer(tmp_path / "b", pcfg, sd, ds, ds, num_train_epochs=50,
                      early_stopping_patience=1, learning_rate=0.0)
    assert len(t.train()) <= 3
    # Resume from the last epoch checkpoint: the step count carries over.
    t2 = _port_trainer(tmp_path / "b", pcfg, sd, ds, ds, num_train_epochs=60)
    assert t2.load_checkpoint(str(tmp_path / "b")) is not None and t2.step == t.step


def test_unfinished_checkpoint_is_skipped(tmp_path):
    for d in ["checkpoint-1", "checkpoint-2-step4.tmp-123", "checkpoint-0-step2",
              "checkpoint-0", "checkpoint-3", "best", "notes"]:
        (tmp_path / d).mkdir()
        if d != "checkpoint-3":  # checkpoint-3: a directory without its state file
            (tmp_path / d / "state.pt").write_bytes(b"")
    assert pt.Trainer._list_checkpoints(str(tmp_path)) == [
        "checkpoint-0-step2", "checkpoint-0", "checkpoint-1"]
    assert pt.Trainer._list_checkpoints(str(tmp_path / "missing")) == []


def test_refused_arguments_and_default_device(monkeypatch):
    # num_model_shards must divide the world size (one process here; the
    # HSDP runs: tests/test_torch_fsdp.py).
    with pytest.raises(ValueError, match="does not divide the world size 1"):
        pt.TrainingArguments(num_model_shards=2)
    from poseidon_tpu_torch.training import arguments
    monkeypatch.setattr(arguments, "process_count", lambda: 4)
    assert pt.TrainingArguments(num_model_shards=2).num_model_shards == 2
    assert pt.TrainingArguments(num_model_shards=4).num_model_shards == 4
    with pytest.raises(ValueError, match="does not divide the world size 4"):
        pt.TrainingArguments(num_model_shards=3)
    monkeypatch.undo()
    # Accepted since gradient checkpointing was ported (tests/test_torch_remat.py).
    assert pt.TrainingArguments(gradient_checkpointing=True).gradient_checkpointing
    from dataclasses import fields
    assert [f.name for f in fields(pt.TrainingArguments)] == [f.name for f in fields(JArgs)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.Trainer(pt.ScOT(pt.ScOTConfig.from_dict(tiny_cfg().to_dict())),
                       pt.TrainingArguments())
