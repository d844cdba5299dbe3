"""The port's Trainer under data parallelism (DDP over the data axis) on the
CPU: two processes in a gloo group (``tests/_torch_dist.py``), each with
its rows of every global batch, against the port in one process at the
same global batch and against the JAX Trainer in one process (its 8-device
data mesh), on ``tests/_multihost_worker.py::run_trial``'s dataset and
model config (fp32, dropout 0), with the same weights (numpy values around
the JAX init, ``from_jax_params``):

- two epochs of ``Trainer.train`` (4 steps; evaluation on 13 samples, the
  last batch of 8 with 5 valid rows, so that rank 1 holds 3 padding rows):
  step losses, grad norms, epoch and evaluation losses, the predictions
  every rank gathers and the parameters: 1e-5 against one process (another
  summation order), rtol 1e-4 against JAX (``tests/test_multihost.py``'s);
- one step on a batch whose two halves (one a rank) differ 10x in label
  scale: the loss, with its normalisers over the whole batch, and the
  gradient against one process and JAX; a per-rank normaliser misses it;
- one AR step of the resnet-skip model: BatchNorm's running statistics
  over the whole batch;
- a checkpoint written at world 2 resumes at world 1 and the reverse, and
  the resumed epoch matches the uninterrupted run;
- a model with parameters the loss does not reach (skip blocks past the
  last stage);
- dropout masks that differ across ranks.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from poseidon_tpu import ScOT as JScOT
from poseidon_tpu import make_config as jmake_config
from poseidon_tpu.metrics import ChannelGroupMetrics as JMetrics
from poseidon_tpu.training import Trainer as JTrainer
from poseidon_tpu.training import TrainingArguments as JArgs

import poseidon_tpu_torch as pt

import _torch_dist as td
from test_torch_model import _values

torch.set_num_threads(1)

RTOL_PORT, RTOL_JAX = 1e-5, 1e-4


def _pair(seed, **overrides):
    """(JAX config, JAX variables, port config dict, port state dict)."""
    jcfg = jmake_config("T", **{**td.TRIAL_CONFIG, **overrides})
    x0 = np.zeros((1, 2, 16, 16), np.float32)
    shapes = jax.eval_shape(JScOT(config=jcfg).init, jax.random.PRNGKey(0), x0,
                            np.zeros((1,), np.float32))
    jvars = _values(dict(shapes), np.random.default_rng(seed))
    pcfg = pt.ScOTConfig.from_dict(jcfg.to_dict())
    sd = pt.from_jax_params(jvars["params"], pcfg, jvars.get("batch_stats"))
    return jcfg, jvars, pcfg.to_dict(), sd


def _batch(n=8):
    ds = td.DecayDataset(n)
    return {k: np.stack([np.asarray(ds[i][k]) for i in range(n)]) for k in ds[0]}


def _log(out):
    with open(os.path.join(out, "logs.jsonl")) as f:
        return [r for r in map(json.loads, f) if "step" in r]


def _model(out, name):
    return torch.load(os.path.join(out, name, "state.pt"), weights_only=True)["model"]


def _close_models(got, want, rtol, atol=1e-6):
    """The whole state within relative L2 ``rtol``, every element within
    ``atol`` (a thousandth of the learning rate: AdamW's first steps scale
    the round-off of near-zero gradients up to a share of the rate)."""
    assert got.keys() == want.keys()
    num = sum(float((got[k].float() - v.float()).pow(2).sum()) for k, v in want.items())
    den = sum(float(v.float().pow(2).sum()) for v in want.values())
    assert (num / den) ** 0.5 <= rtol
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


def _jax_step(jcfg, jvars, batch, ar_steps=None, **kw):
    jt = JTrainer(JScOT(config=jcfg), JArgs(output_dir="unused", **{**td.TRIAL_ARGS, **kw}),
                  train_dataset=td.DecayDataset(td.N_TRAIN), variables=jvars)
    if ar_steps is not None:
        jt.set_ar_steps(ar_steps)
    state, m = jax.jit(jt._train_step)(jt.state, jt._device_batch(dict(batch)),
                                       jax.random.PRNGKey(0))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "state": state}


def _without(src, dst, *names):
    shutil.copytree(src, dst)
    for n in names:
        path = os.path.join(dst, n)
        shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
    return str(dst)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp")
    jcfg, jvars, cfg, sd = _pair(0)
    bn_jcfg, bn_jvars, bn_cfg, bn_sd = _pair(4, residual_model="resnet")
    unused_cfg = pt.ScOTConfig.from_dict({**cfg, "skip_connections": (1, 0, 1)})
    unused_sd = pt.build_model(unused_cfg, device="cpu", seed=2).state_dict()
    dropout_cfg = {**cfg, "hidden_dropout_prob": 0.5}
    # Labels near the predictions' scale (so that the normalisers weigh),
    # rank 1's rows 10x rank 0's.
    scale = _batch()
    scale["labels"][:4] *= 0.01
    scale["labels"][4:] *= 0.1
    bn_batch = _batch()

    # One process first: its epoch-0 checkpoint is what world 2 resumes.
    one = td.train_run(root / "one", cfg, sd)
    src1 = _without(root / "one", root / "one_ckpt0", "checkpoint-1", "logs.jsonl")
    procs = td.start_ranks(
        "_torch_dist:ddp_suite", 2, root / "ranks", root=str(root / "ranks"), config=cfg,
        state=sd, resume_from=src1, scale_batch=scale, bn_config=bn_cfg, bn_state=bn_sd,
        bn_batch=bn_batch, unused_config=unused_cfg.to_dict(), unused_state=unused_sd,
        dropout_config=dropout_cfg)
    try:
        # The JAX Trainer and the one-process port while the ranks run.
        ev = td.DecayDataset(td.N_EVAL)
        jt = JTrainer(JScOT(config=jcfg), JArgs(output_dir=str(root / "jax"), **td.TRIAL_ARGS),
                      train_dataset=td.DecayDataset(td.N_TRAIN), eval_dataset=ev,
                      compute_metrics=JMetrics(ev.channel_slice_list,
                                               ev.printable_channel_description),
                      variables=jvars)
        jax_run = {"history": jt.train(), "predict": jt._predict_arrays(ev)}
        out = {"one": one, "jax": jax_run, "root": root,
               "jax_scale": _jax_step(jcfg, jvars, scale),
               "jax_bn": _jax_step(bn_jcfg, bn_jvars, bn_batch, ar_steps=2, learning_rate=1e-4),
               "one_scale": td.one_step(cfg, sd, scale),
               "one_bn": td.one_step(bn_cfg, bn_sd, bn_batch, ar_steps=2, learning_rate=1e-4),
               "one_unused": td.one_step(unused_cfg.to_dict(), unused_sd, scale),
               "one_dropout": td.dropout_draws(dropout_cfg, sd),
               "bn_pcfg": pt.ScOTConfig.from_dict(bn_cfg), "bn_state": bn_sd}
    finally:
        ranks = procs.results()
    out["ranks"] = ranks
    # World 2 -> 1: the two-rank run's epoch-0 checkpoint resumed in one process.
    src2 = _without(root / "ranks" / "train", root / "two_ckpt0", "checkpoint-1", "logs.jsonl")
    out["resumed_one"] = td.train_run(root / "resumed_one", cfg, sd, resume_from=src2)
    return out


def test_ddp_trainer_matches_one_process(runs):
    root, one = runs["root"], runs["one"]
    want = _log(root / "one")
    got = _log(root / "ranks" / "train")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 4]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want], rtol=RTOL_PORT)
    for rank in runs["ranks"]:
        r = rank["train"]
        assert r["step"] == 4
        for h, w in zip(r["history"], one["history"]):
            np.testing.assert_allclose([h["train_loss"], h["eval_loss"]],
                                       [w["train_loss"], w["eval_loss"]], rtol=RTOL_PORT)
        np.testing.assert_allclose(r["preds"], one["preds"], rtol=RTOL_PORT, atol=1e-6)
        np.testing.assert_array_equal(r["labels"], one["labels"])
    _close_models(runs["ranks"][0]["train"]["model"], one["model"], RTOL_PORT)
    assert runs["ranks"][1]["train"]["model"].keys() == one["model"].keys()
    for k, v in runs["ranks"][0]["train"]["model"].items():
        assert torch.equal(runs["ranks"][1]["train"]["model"][k], v), k


def test_ddp_trainer_matches_jax(runs):
    root, jax_run = runs["root"], runs["jax"]
    want = [r for r in _log(root / "jax") if "loss" in r]
    got = _log(root / "ranks" / "train")
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want],
                               rtol=RTOL_JAX)
    jpreds, jlabels, jloss = jax_run["predict"]
    for rank in runs["ranks"]:
        r = rank["train"]
        for h, w in zip(r["history"], jax_run["history"]):
            np.testing.assert_allclose([h["train_loss"], h["eval_loss"]],
                                       [w["train_loss"], w["eval_loss"]], rtol=RTOL_JAX)
            np.testing.assert_allclose(h["eval_u/median_relative_l1_error"],
                                       w["eval_u/median_relative_l1_error"], rtol=RTOL_JAX)
        np.testing.assert_allclose(r["pred_loss"], jloss, rtol=RTOL_JAX)
        np.testing.assert_allclose(r["preds"], np.asarray(jpreds), rtol=RTOL_JAX, atol=2e-5)
        np.testing.assert_array_equal(r["labels"], np.asarray(jlabels))


def test_uneven_last_eval_batch_masks_global_rows(runs):
    """13 samples at a global batch of 8: the last batch has 5 valid rows,
    rank 1's last 3 are padding. Every rank gathers the 13 predictions, and
    the loss weighs the padding out on both ranks."""
    one = runs["one"]
    for rank in runs["ranks"]:
        r = rank["train"]
        assert r["preds"].shape == (td.N_EVAL, 2, 16, 16)
        np.testing.assert_allclose(r["pred_loss"], one["pred_loss"], rtol=RTOL_PORT)
        np.testing.assert_allclose(r["history"][-1]["eval_loss"],
                                   one["history"][-1]["eval_loss"], rtol=RTOL_PORT)


def test_label_scale_differs_across_shards(runs):
    """Rank 1's rows have 10x the labels of rank 0's. The loss normalises
    each channel group by the whole batch's label scale, as JAX does; the
    mean of per-rank normalised losses is another number (1.52 for 1.12)."""
    want_jax, want_one = runs["jax_scale"], runs["one_scale"]
    for rank in runs["ranks"]:
        got = rank["scale"]
        np.testing.assert_allclose([got["loss"], got["grad_norm"]],
                                   [want_one["loss"], want_one["grad_norm"]], rtol=RTOL_PORT)
        np.testing.assert_allclose([got["loss"], got["grad_norm"]],
                                   [want_jax["loss"], want_jax["grad_norm"]], rtol=RTOL_JAX)
        _close_models(got["model"], want_one["model"], RTOL_PORT)
        assert abs(rank["naive"] - want_one["loss"]) > 0.05 * want_one["loss"]


def test_batchnorm_statistics_over_the_global_batch(runs):
    """One AR step (two rollout steps) of the resnet-skip model: the
    running statistics on both ranks equal the one-process step's and the
    JAX step's (atol 2e-5, tests/test_torch_trainer_ar.py's gate), with the
    loss and grad norm."""
    jbn, one = runs["jax_bn"], runs["one_bn"]
    ref = pt.from_jax_params(jax.tree.map(np.asarray, jbn["state"].params), runs["bn_pcfg"],
                             jax.tree.map(np.asarray, jbn["state"].batch_stats))
    stats = [k for k in ref if "running_" in k]
    assert stats
    for rank in runs["ranks"]:
        got = rank["bn"]
        np.testing.assert_allclose([got["loss"], got["grad_norm"]], [one["loss"], one["grad_norm"]],
                                   rtol=RTOL_PORT)
        np.testing.assert_allclose([got["loss"], got["grad_norm"]], [jbn["loss"], jbn["grad_norm"]],
                                   rtol=RTOL_JAX)
        for k in stats:
            assert not torch.equal(got["model"][k], runs["bn_state"][k]), k
            np.testing.assert_allclose(got["model"][k].numpy(), one["model"][k].numpy(), atol=1e-6,
                                       rtol=0, err_msg=k)
            np.testing.assert_allclose(got["model"][k].numpy(), ref[k].numpy(), atol=2e-5, rtol=0,
                                       err_msg=k)


def test_checkpoints_resume_across_world_sizes(runs):
    """Epoch 0's checkpoint of the two-rank run resumed in one process, and
    the one-process run's resumed on two ranks: epoch 1's steps and the
    epoch-1 checkpoint as in the uninterrupted one-process run."""
    root = runs["root"]
    want = [r for r in _log(root / "one") if r["epoch"] == 1]
    want_model = _model(root / "one", "checkpoint-1")
    for out in (root / "resumed_one", root / "ranks" / "resumed"):
        got = _log(out)
        assert [r["step"] for r in got] == [r["step"] for r in want] == [3, 4]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                                       rtol=RTOL_PORT)
        _close_models(_model(out, "checkpoint-1"), want_model, RTOL_PORT)
    assert runs["resumed_one"]["step"] == 4
    assert [r["resumed"]["step"] for r in runs["ranks"]] == [4, 4]


def test_parameters_the_loss_does_not_reach(runs):
    """Skip blocks past the last stage take no part in the loss: their
    gradients are None on every rank, and the rest reduce as in one
    process."""
    want = runs["one_unused"]
    for rank in runs["ranks"]:
        got = rank["unused"]
        np.testing.assert_allclose([got["loss"], got["grad_norm"]],
                                   [want["loss"], want["grad_norm"]], rtol=RTOL_PORT)
        _close_models(got["model"], want["model"], RTOL_PORT)


def test_dropout_masks_differ_across_ranks(runs):
    """The ranks' generators of one step differ (their rows differ); in one
    process the generator is (seed, step)'s, as before."""
    a, b = (r["dropout"] for r in runs["ranks"])
    assert not torch.equal(a["draws"], b["draws"])
    assert not torch.equal(a["pred"], b["pred"])
    seed = int(np.random.SeedSequence([0, 5]).generate_state(1)[0])
    one = runs["one_dropout"]
    assert torch.equal(one["draws"], torch.rand(4, generator=torch.Generator().manual_seed(seed)))
    assert not torch.equal(one["draws"], a["draws"]) or not torch.equal(one["draws"], b["draws"])
