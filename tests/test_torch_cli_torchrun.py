"""The port's train command line under ``torchrun`` on the CPU (gloo): two
processes started by ``torchrun --standalone --nproc_per_node 2`` (the
launch the README documents) on tests/test_torch_cli_train.py's synthetic
AllenCahn file and tiny config, against one process
(``tests/_torchrun_train.py`` without ``torchrun``) at the same global
batch: ``batch_size`` is per device, so one process at ``batch_size`` 2
takes the steps that two data-parallel processes take at 1 each
(``dp_size = world // num_model_shards``), and two processes with
``num_model_shards`` 2 (HSDP, ``dp_size`` 1) at 2. The run directory has
the one-process run's layout, process 0 alone writes it (one log line a
step, no second writer's temporary directories, the model size printed
once), and the step losses agree within 1e-5.
"""

import json
import os
import subprocess
import sys

import numpy as np

from test_torch_cli_train import TINY, _argv, ace_dir  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "_torchrun_train.py")
CONFIG = dict(TINY, num_epochs=1)


def _run(ace_dir, out, world, **config):
    argv = _argv(ace_dir, out, "r", {**CONFIG, **config}, "--train_small_time_transition",
                 "--device", "cpu")
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(world)] if world > 1 else [sys.executable])
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([*launch, SCRIPT, *argv], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    run = os.path.join(out, "proj", "r")
    with open(os.path.join(run, "logs.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    return run, logs, res.stdout


def test_torchrun_two_processes_match_one(ace_dir, tmp_path):
    one, one_logs, _ = _run(ace_dir, tmp_path / "one", 1, batch_size=2)
    steps = [r for r in one_logs if "step" in r]
    assert steps
    for name, world, config in (("ddp", 2, {"batch_size": 1}),
                                ("hsdp", 2, {"batch_size": 2, "num_model_shards": 2})):
        run, logs, stdout = _run(ace_dir, tmp_path / name, world, **config)
        assert sorted(os.listdir(run)) == sorted(os.listdir(one)) == [
            "best", "checkpoint-0", "config.json", "logs.jsonl", "model"], name
        assert [sorted(r) for r in logs] == [sorted(r) for r in one_logs], name
        got = [r for r in logs if "step" in r]
        assert [r["step"] for r in got] == [r["step"] for r in steps], name
        np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in steps],
                                   rtol=1e-5, err_msg=name)
        assert stdout.count("Model size:") == 1, name
        with open(os.path.join(run, "config.json")) as f, \
                open(os.path.join(one, "config.json")) as g:
            assert json.load(f) == json.load(g)
