"""The harness on the CPU: what it refuses, what it loads, and ``correct``
on toy cells, sound and with the timed path broken underneath, one of them
on two ranks over gloo; the launcher of ranks and the cores it gives them."""

import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import check, harness, ranks, run as bench_run, spec, trace
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


def test_a_cell_on_two_cards_without_them_exits_nonzero_and_prints_no_result(
        toy_root, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(bench_run, "ROOT", toy_root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TRITON_CACHE_DIR", str(toy_root / "build"))
    assert bench_run.main(["--workload", "toy.train_ddp", "--seed", str(2**31 + 7),
                           "--seconds", "1", "--trace", "0"]) != 0
    assert "metrics" not in capsys.readouterr().out


TOP_LEVEL = ("import sys; print(sorted({m.split('.')[0] for m in sys.modules}))")


def test_the_harness_loads_no_jax(toy_root):
    code = ("import benchmark.run, benchmark.harness, benchmark.calibrate, benchmark.ranks\n"
            "import poseidon_tpu_torch\n"
            "from pathlib import Path\n"
            "from benchmark import spec\n"
            "for w in ('scot_b.train.b256', 'scot_l.train.b128', 'scot_b.rollout.b256'):\n"
            "    spec.load_cell(w)\n"
            f"spec.load_cell('toy.train_ddp', Path({str(toy_root)!r}))\n" + TOP_LEVEL)
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


# The keys of a one-card cell's result line, and of its end-to-end metrics.
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]
E2E_KEYS = {"toy.train": ["train_samples_per_s", "peak_mem_gib", "setup_s"],
            "toy.rollout": ["rollout_states_per_s", "peak_mem_gib", "setup_s"]}


@pytest.mark.parametrize("name", ["toy.train", "toy.rollout"])
def test_a_sound_toy_run_is_correct(toy_root, name):
    correct, run = _run(toy_root, name)
    assert correct, run["numbers"]
    assert run["attempted"] >= 1
    line = bench_run.result_line(spec.load_cell(name, toy_root), run, False, {})
    assert list(line) == LINE_KEYS
    assert list(line["metrics"]) == E2E_KEYS[name]


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


# Two ranks over gloo: each joins the group, then runs the toy DDP cell
# sound and under each fault in turn; rank 0 prints a line a run.
RANK = """
import json, sys, time
from pathlib import Path
t0 = time.perf_counter()
from benchmark import check, harness, ranks, run as bench_run, spec, trace
rank, port, root = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
cell = spec.load_cell("toy.train_ddp", root)
group = ranks.start(rank, 2, port, "cpu")
for fault in ("", "unchanged", "half_batch", "no_exchange"):
    run = harness.run(cell, 2**31 + 23, 0.3, False, t0, device="cpu", fault=fault or None,
                      ranks=group)
    if run is not None:
        line = bench_run.result_line(cell, run, False, {})
        print(json.dumps(dict(line, fault=fault, numbers=run["numbers"])), flush=True)
    t0 = time.perf_counter()
"""


@pytest.fixture(scope="module")
def ddp_toy_runs(toy_root):
    port = ranks.free_port()
    code, out, err = ranks.launch([[sys.executable, "-c", RANK, str(r), str(port), str(toy_root)]
                                   for r in range(2)])
    assert code == 0, err[-4000:]
    return {d["fault"]: d for d in map(json.loads, out.strip().splitlines())}


def test_two_ranks_over_gloo_run_the_toy_ddp_cell_correct(ddp_toy_runs):
    line = ddp_toy_runs[""]
    assert line["correct"], line["numbers"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line["metrics"]) == ["train_samples_per_s", "peak_mem_gib", "setup_s"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange"])
def test_a_broken_ddp_step_is_not_correct(ddp_toy_runs, fault):
    assert not ddp_toy_runs[fault]["correct"], ddp_toy_runs[fault]["numbers"]


FAILING = """
import sys
from benchmark import ranks
rank, port = int(sys.argv[1]), int(sys.argv[2])
group = ranks.start(rank, 2, port, "cpu")
if rank == 1:
    raise RuntimeError("rank 1 fails")
group.barrier()
print("a result line")
"""


def test_a_rank_that_raises_stops_the_run_with_no_line():
    port = ranks.free_port()
    t = time.monotonic()
    code, out, err = ranks.launch([[sys.executable, "-c", FAILING, str(r), str(port)]
                                   for r in range(2)])
    assert time.monotonic() - t < 120
    assert code != 0 and out == ""
    assert "rank 1 fails" in err and "rank 1 exited with code 1" in err


TOPO = ("\tGPU0\tGPU1\tGPU2\tGPU3\tCPU Affinity\tNUMA Affinity\tGPU NUMA ID\n"
        "GPU0\t X \tNV18\tNV18\tNV18\t0-7,32-39\t0\t\tN/A\n"
        "GPU1\tNV18\t X \tNV18\tNV18\t0-7,32-39\t0\t\tN/A\n"
        "GPU2\tNV18\tNV18\t X \tNV18\t8-15\t1\t\tN/A\n"
        "GPU3\tNV18\tNV18\tNV18\t X \t8-15\t1\t\tN/A\n\nLegend:\n  X    = Self\n")


def test_each_rank_gets_its_own_cores_near_its_card():
    near = ranks.nearest_cpus(TOPO)
    assert near == {0: set(range(8)) | set(range(32, 40)), 1: set(range(8)) | set(range(32, 40)),
                    2: set(range(8, 16)), 3: set(range(8, 16))}
    assert ranks.share_cores(4, set(range(16)), near) == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11], [12, 13, 14, 15]]
    # Cards with no allowed core near them, or no topology: an even split.
    assert ranks.share_cores(4, set(range(16, 24)), near) == [
        [16, 17], [18, 19], [20, 21], [22, 23]]
    assert ranks.share_cores(2, set(range(5)), {}) == [[0, 1], [2, 3, 4]]
    assert ranks.parse_cpus("N/A") == set()


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur}


def test_nccl_device_ms_by_hand():
    # Two profiled steps (us): each an attention kernel, a GEMM, two NCCL
    # all-reduces (one overlapping the GEMM), and an elementwise kernel.
    events = []
    for t0 in (0.0, 1000.0):
        events += [_kernel("attn_bwd_kernel<256, 64>", t0, 300),
                   _kernel("nvjet_tst_128x64", t0 + 300, 200),
                   _kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)",
                           t0 + 400, 150),
                   _kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)",
                           t0 + 600, 50),
                   _kernel("vectorized_elementwise_kernel<4>", t0 + 700, 100)]
    prof = dict(trace.reduce_trace(events), calls=2)
    read = spec.load_reader(REPO / "benchmark/metrics/nccl_device_ms.train.py")
    assert read({"kind": "train", "profile": prof}) == pytest.approx(0.2)
    assert read({"kind": "rollout", "profile": prof}) is None
    plain = dict(trace.reduce_trace([e for e in events if "nccl" not in e["name"]]), calls=2)
    assert read({"kind": "train", "profile": plain}) is None


CALIBRATE = """
import sys, torch
from pathlib import Path
from benchmark import calibrate, ranks, spec
rank, port, root = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
group = ranks.start(rank, 2, port, "cpu")
cell = spec.load_cell("toy.train_ddp", root)
plan = [("program", 5), ("control", 6), ("no_exchange", 7)]
calibrate.readings(cell, torch.device("cpu"), plan, group)
"""


def test_calibration_on_two_ranks_prints_each_reading_in_order(toy_root):
    port = ranks.free_port()
    code, out, err = ranks.launch([[sys.executable, "-c", CALIBRATE, str(r), str(port),
                                    str(toy_root)] for r in range(2)])
    assert code == 0, err[-4000:]
    lines = [json.loads(x) for x in out.strip().splitlines()]
    assert [(d["what"], d["seed"]) for d in lines] == [("program", 5), ("control", 6),
                                                        ("no_exchange", 7)]
    cell = spec.load_cell("toy.train_ddp", toy_root)
    assert [check.judge(d["numbers"], cell.limits) for d in lines] == [True, False, False]
