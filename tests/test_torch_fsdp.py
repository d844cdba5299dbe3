"""The port's Trainer under HSDP (FSDP2 ``fully_shard`` per Swin block and at
the root over the (data, model) mesh) on the CPU: two processes in a gloo
group (``tests/_torch_dist.py``) on a 1 x 2 mesh, both ranks on every row,
every parameter and AdamW moment sharded over ``model``. Against DDP (2 x 1)
on the same two processes and the port in one process, at the same global
batch, fp32, the toy model and data of ``tests/test_torch_ddp.py``:

- two epochs of ``Trainer.train``, every step's gradient clipped: step
  losses, grad norms (the norm of the whole gradient from the shards),
  epoch and evaluation losses, predictions and parameters within 1e-5;
- ``assert_opt_state_sharded`` passes on the HSDP optimizer and fails on
  moments that are not sharded;
- the checkpoint is the whole state in the one-process format, written by
  rank 0: it resumes in one process, and a one-process checkpoint resumes
  under HSDP, each epoch as the uninterrupted run's.
"""

import os

import numpy as np
import pytest
import torch

import _torch_dist as td
from test_torch_ddp import _close_models, _log, _model, _pair, _without

torch.set_num_threads(1)

RTOL = 1e-5
# Below every step's grad norm: the clip scales the shards of every step.
CLIP = {"max_grad_norm": 1e-3}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp")
    _, _, cfg, sd = _pair(0)
    one = td.train_run(root / "one", cfg, sd, **CLIP)
    src1 = _without(root / "one", root / "one_ckpt0", "checkpoint-1", "logs.jsonl")
    ranks = td.run_ranks("_torch_dist:fsdp_suite", 2, root / "ranks", root=str(root / "ranks"),
                         config=cfg, state=sd, resume_from=src1, **CLIP)
    src2 = _without(root / "ranks" / "hsdp", root / "hsdp_ckpt0", "checkpoint-1", "logs.jsonl")
    return {"root": root, "one": one, "ranks": ranks,
            "resumed_one": td.train_run(root / "resumed_one", cfg, sd, resume_from=src2, **CLIP)}


def test_hsdp_matches_ddp_and_one_process(runs):
    root, one = runs["root"], runs["one"]
    want = _log(root / "one")
    for run in ("hsdp", "ddp"):
        got = _log(root / "ranks" / run)
        assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 4]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want], rtol=RTOL,
                                       err_msg=f"{run} {key}")
        for rank in runs["ranks"]:
            r = rank[run]
            for h, w in zip(r["history"], one["history"]):
                np.testing.assert_allclose([h["train_loss"], h["eval_loss"]],
                                           [w["train_loss"], w["eval_loss"]], rtol=RTOL)
            np.testing.assert_allclose(r["preds"], one["preds"], rtol=RTOL, atol=1e-6)
        _close_models(runs["ranks"][0][run]["model"], one["model"], RTOL)
    # The whole state is gathered to rank 0 only.
    assert runs["ranks"][1]["hsdp"]["model"] == {}


def test_opt_state_sharded_over_model(runs):
    for rank in runs["ranks"]:
        m = rank["moments"]
        assert m["checked"] > 0
        assert "NOT sharded over the 'model' mesh axis" in m["error"]


def test_full_state_checkpoint_resumes_at_any_world_size(runs):
    root = runs["root"]
    got = torch.load(os.path.join(root / "ranks" / "hsdp", "checkpoint-1", "state.pt"),
                     weights_only=True)
    want = torch.load(os.path.join(root / "one", "checkpoint-1", "state.pt"), weights_only=True)
    assert got.keys() == want.keys() and got["meta"] == want["meta"]
    assert got["step"] == want["step"] == 4
    _close_models(got["model"], want["model"], RTOL)
    go, wo = got["optimizer"], want["optimizer"]
    assert [g["params"] for g in go["param_groups"]] == [g["params"] for g in wo["param_groups"]]
    assert go["state"].keys() == wo["state"].keys()
    for i, s in wo["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert go["state"][i][k].shape == s[k].shape
            np.testing.assert_allclose(go["state"][i][k].numpy(), s[k].numpy(), rtol=1e-4,
                                       atol=1e-9)
    want_log = [r for r in _log(root / "one") if r["epoch"] == 1]
    for out in (root / "resumed_one", root / "ranks" / "resumed"):
        got_log = _log(out)
        assert [r["step"] for r in got_log] == [3, 4]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([r[key] for r in got_log], [r[key] for r in want_log],
                                       rtol=RTOL)
        _close_models(_model(out, "checkpoint-1"), _model(root / "one", "checkpoint-1"), RTOL)
