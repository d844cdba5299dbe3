"""The harness on the CPU: what it refuses, what it loads, and ``correct``
on toy cells, sound and with the timed path broken underneath."""

import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import check, harness, spec
from benchmark.tests.toy import REPO


def _python(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=env)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "scot_b.train.b256", "--seed", str(2**31 + 7), "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert "metrics" not in out.stdout


TOP_LEVEL = ("import sys; print(sorted({m.split('.')[0] for m in sys.modules}))")


def test_the_harness_loads_no_jax():
    code = ("import benchmark.run, benchmark.harness, benchmark.calibrate, poseidon_tpu_torch\n"
            "from benchmark import spec\n"
            "for w in ('scot_b.train.b256', 'scot_l.train.b128', 'scot_b.rollout.b256'):\n"
            "    spec.load_cell(w)\n" + TOP_LEVEL)
    out = _python(code)
    names = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not names & {"jax", "jaxlib", "flax", "poseidon_tpu"}
    assert "poseidon_tpu_torch" in names


def test_the_reference_loads_nothing_of_either_package():
    code = ("import benchmark.reference.scot, benchmark.reference.train, "
            "benchmark.reference.precision\n" + TOP_LEVEL)
    names = set(json.loads(_python(code).stdout.strip().replace("'", '"')))
    assert not names & {"jax", "jaxlib", "flax", "poseidon_tpu", "poseidon_tpu_torch"}


def test_the_forbidden_module_check_compares_whole_names():
    code = ("import sys, types; sys.modules['poseidon_tpu_torch_x'] = types.ModuleType('x')\n"
            "from benchmark.run import forbidden_modules; print(forbidden_modules())\n"
            "sys.modules['jax.numpy'] = types.ModuleType('y'); print(forbidden_modules())")
    assert _python(code).stdout.split("\n")[:2] == ["[]", "['jax']"]


def test_a_cell_is_found_by_name_from_its_own_files(tmp_path):
    here = tmp_path / "benchmark"
    for d in ("configs", "traffic", "limits", "metrics"):
        (here / d).mkdir(parents=True)
    (here / "configs/dummy.json").write_text(json.dumps({"model": {"x": 1}}))
    (here / "traffic/burst.json").write_text(json.dumps({"loop": "train", "batch": 3}))
    (here / "limits/dummy.burst.json").write_text(json.dumps({"gap": 0.5}))
    (here / "metrics/rate.py").write_text("def read(ctx):\n    return 2.0 * ctx['x']\n")
    (here / "metrics/setup_s.py").write_text("def read(ctx):\n    return 1.0\n")
    (here / "metrics/depth.py").write_text("def read(ctx):\n    return None\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "dummy", "file": "benchmark/configs/dummy.json"}],
        "workloads": [{"name": "dummy.burst", "config": "dummy", "traffic": "burst", "chips": 1},
                      {"name": "other", "config": "dummy", "traffic": "burst", "chips": 1}],
        "end_to_end": [{"name": "rate", "unit": "x/s", "workloads": ["dummy.burst"]},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "depth", "unit": "ms", "moves": "rate"}]}))
    cell = spec.load_cell("dummy.burst", tmp_path)
    assert (cell.chips, cell.config, cell.traffic["batch"], cell.limits) == (
        1, {"model": {"x": 1}}, 3, {"gap": 0.5})
    assert [m.name for m in cell.metrics_for(False)] == ["rate", "setup_s"]
    assert [m.read({"x": 4}) for m in cell.metrics_for(False)] == [8.0, 1.0]
    assert [m.name for m in cell.metrics_for(True)] == ["depth"]
    (here / "limits/other.json").write_text(json.dumps({}))
    other = spec.load_cell("other", tmp_path)
    assert [m.name for m in other.metrics] == ["setup_s"]
    with pytest.raises(KeyError):
        spec.load_cell("missing", tmp_path)


def _run(root, name, fault=None, seed=2**31 + 11):
    cell = spec.load_cell(name, root)
    run = harness.run(cell, seed, 0.3, False, time.perf_counter(), device="cpu", fault=fault)
    return check.judge(run["numbers"], cell.limits) and run["failed"] == 0, run


@pytest.mark.parametrize("name", ["toy.train", "toy.rollout"])
def test_a_sound_toy_run_is_correct(toy_root, name):
    correct, run = _run(toy_root, name)
    assert correct, run["numbers"]
    assert run["attempted"] >= 1


@pytest.mark.parametrize("name,fault", [
    ("toy.train", "unchanged"), ("toy.train", "half_batch"),
    ("toy.rollout", "unchanged"), ("toy.rollout", "half_batch"), ("toy.rollout", "altered")])
def test_a_broken_timed_path_is_not_correct(toy_root, name, fault):
    correct, run = _run(toy_root, name, fault)
    assert not correct, run["numbers"]


def test_the_control_is_not_correct(toy_root):
    for name, control in (("toy.train", harness.train_control),
                          ("toy.rollout", harness.rollout_control)):
        cell = spec.load_cell(name, toy_root)
        numbers = control(cell, 2**31 + 17, "cpu")
        assert not check.judge(numbers, cell.limits), (name, numbers)


@pytest.mark.cuda
def test_the_rollout_control_fails_at_the_cells_size():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell("scot_b.rollout.b256")
    numbers = harness.rollout_control(cell, 2**31 + 19, torch.device("cuda"))
    assert not check.judge(numbers, cell.limits), numbers
