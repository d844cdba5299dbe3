"""``bench_torch.py``, the port's train-step bench, on the CPU at a toy
geometry (two stages of two blocks, width 32, 32x32, batch 2): its
configuration against ``bench.py``'s (built by the JAX package from the
arguments ``bench.py`` passes), its steps against ``train_step``, the LR
that its CUDA graph reads against the eager schedule, its FLOP count
against a direct count and against the products counted from shapes, and
its refusal to run without CUDA."""

import ast
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils.flop_counter import FlopCounterMode

import poseidon_tpu_torch as pt

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench_torch  # noqa: E402

torch.set_num_threads(2)

TOY = dict(image_size=32, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
           skip_connections=(1, 0), window_size=4)
BATCH = 2


def _bench_py_make_config_call():
    """The positional and keyword arguments of ``bench.py``'s
    ``make_config`` call, as literals (the size is its first argument)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "make_config"]
    assert len(calls) == 1
    return {kw.arg: ast.literal_eval(kw.value) for kw in calls[0].keywords}


@pytest.mark.parametrize("size", ["B", "L"])
def test_config_equals_bench_py(size):
    from poseidon_tpu import make_config as jmake_config

    kwargs = _bench_py_make_config_call()
    jcfg = jmake_config(size, **kwargs).to_dict()
    pcfg = bench_torch.bench_config(size).to_dict()
    shared = set(jcfg) & set(pcfg)
    assert {"embed_dim", "depths", "image_size", "channel_slice_list_normalized_loss",
            "attention_impl", "score_dtype", "use_conditioning"} <= shared
    for key in sorted(shared):
        a, b = jcfg[key], pcfg[key]
        if isinstance(a, (list, tuple)):
            a, b = list(a), list(b)
        assert a == b, key


def _toy():
    return bench_torch.bench_config("T", **TOY)


def _expected_batch(cfg):
    gen = torch.Generator().manual_seed(0)
    shape = (BATCH, 4, cfg.image_size, cfg.image_size)
    x = torch.randn(shape, generator=gen)
    labels = torch.randn(shape, generator=gen)
    mask = torch.tensor([[False, False, False, True]] * BATCH)
    return {"pixel_values": x, "time": torch.full((BATCH,), 0.5), "labels": labels,
            "pixel_mask": mask}


def test_bench_steps_equal_train_step():
    cfg = _toy()
    model, opt, sched = bench_torch.build(cfg, "cpu")
    batch = bench_torch.make_batch(cfg, BATCH, "cpu")
    ref_batch = _expected_batch(cfg)
    assert all(torch.equal(batch[k], ref_batch[k]) for k in ref_batch)

    ref_model = pt.build_model(cfg, device="cpu", dtype=torch.bfloat16, seed=0)
    ref_opt, ref_sched = pt.build_optimizer(
        ref_model, learning_rate=1e-4, total_steps=10_000, weight_decay=1e-6,
        lr_scheduler_type="cosine", warmup_ratio=0.0)
    for _ in range(2):
        out = bench_torch.eager_step(model, opt, sched, batch)
        ref = pt.train_step(ref_model, ref_opt, ref_sched, ref_batch, max_grad_norm=5.0)
        assert torch.equal(out["loss"], ref["loss"])
        assert torch.equal(out["grad_norm"], ref["grad_norm"])
    ref_params = dict(ref_model.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, ref_params[name]), name
    assert [g["lr"] for g in opt.param_groups] == [g["lr"] for g in ref_opt.param_groups]


def test_graph_lr_follows_the_schedule():
    # What a CUDA graph's optimizer reads before each replay: the LR the
    # eager LambdaLR gives each group at that step (a cosine over 4 steps,
    # then held at 0).
    cfg = _toy()
    model = pt.build_model(cfg, device="cpu", dtype=torch.bfloat16)
    opts = [pt.build_optimizer(model, learning_rate=1e-4, total_steps=4,
                               learning_rate_time_embedding=3e-4) for _ in range(2)]
    (opt, sched), (ref_opt, ref_sched) = opts
    device_lr = bench_torch._DeviceLR(opt, sched, torch.device("cpu"))
    seen = []
    for _ in range(6):
        device_lr.set()
        lrs = [float(g["lr"]) for g in opt.param_groups]
        assert lrs == pytest.approx([g["lr"] for g in ref_opt.param_groups], rel=1e-6)
        seen.append(lrs)
        ref_opt.step()
        ref_sched.step()
    device_lr.step()   # inside a capture: nothing
    assert [float(g["lr"]) for g in opt.param_groups] == seen[-1]
    assert len(opt.param_groups) == 3 and seen[0] == pytest.approx([1e-4, 1e-4, 3e-4])
    assert len({tuple(v) for v in seen}) == 5 and seen[4] == seen[5] == [0.0] * 3


def test_flop_extension_equals_direct_count():
    cfg = _toy()
    model = pt.build_model(cfg.replace(attention_impl="xla"), device="cpu",
                           dtype=torch.bfloat16).train()
    direct = bench_torch.count_flops(model, bench_torch.make_batch(cfg, 4, "cpu"))
    assert bench_torch.flops_per_step(cfg, 4, "cpu") == direct


def test_conv_backward_counts_groups():
    # torch's own formula counts a depthwise convolution's weight gradient
    # as a dense one's; the bench's counts each gradient as one forward.
    x = torch.randn(2, 8, 6, 6, requires_grad=True)
    w = torch.randn(8, 1, 3, 3, requires_grad=True)
    fixed = {torch.ops.aten.convolution_backward: bench_torch._conv_backward_flop}
    with FlopCounterMode(display=False, custom_mapping=fixed) as counter:
        torch.nn.functional.conv2d(x, w, padding=1, groups=8).sum().backward()
    assert counter.get_total_flops() == 3 * (2 * 2 * 8 * 6 * 6 * 9)


class _ShapeProducts(TorchFunctionMode):
    """2 M K N of every product the forward calls, from its operands'
    shapes: ``@`` / ``matmul`` and ``F.linear`` (rows x in x out),
    ``F.conv2d`` (output elements x kernel taps x input channels a group),
    and two-operand ``einsum`` (2 x the product of every index's extent:
    4 T^2 D per window-head pair for the attention's two)."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if name in ("matmul", "__matmul__", "__rmatmul__"):
            a = args[1] if name == "__rmatmul__" else args[0]
            self.flops += 2 * out.numel() * a.shape[-1]
        elif name == "linear":
            self.flops += 2 * out.numel() * args[0].shape[-1]
        elif name == "conv2d":
            w = args[1]
            self.flops += 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        elif name == "einsum":
            spec = args[0].replace(" ", "").split("->")[0].split(",")
            extents = {}
            for letters, t in zip(spec, args[1:]):
                extents.update(zip(letters, t.shape))
            self.flops += 2 * math.prod(extents.values())
        return out


def test_flop_count_is_three_forwards_of_products():
    cfg = _toy()
    model = pt.build_model(cfg.replace(attention_impl="xla"), device="cpu",
                           dtype=torch.bfloat16).train()
    data = bench_torch.make_batch(cfg, BATCH, "cpu")
    counter = _ShapeProducts()
    with counter, torch.no_grad():
        model(data["pixel_values"], data["time"])
    counted = bench_torch.flops_per_step(cfg, BATCH, "cpu")
    assert counter.flops > 0
    assert abs(counted / (3 * counter.flops) - 1) <= 0.02, (counted, 3 * counter.flops)


def test_span_and_busy_of_a_trace():
    # Kernels 0-10 and 5-12 overlap, a copy at 20-25, a set at 30-31; host
    # events and the device annotation of a range do not count (us).
    events = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": 10},
              {"ph": "X", "cat": "kernel", "ts": 5, "dur": 7},
              {"ph": "X", "cat": "gpu_memcpy", "ts": 20, "dur": 5},
              {"ph": "X", "cat": "gpu_memset", "ts": 30, "dur": 1},
              {"ph": "X", "cat": "cuda_runtime", "ts": -50, "dur": 200},
              {"ph": "X", "cat": "gpu_user_annotation", "ts": -5, "dur": 100},
              {"ph": "i", "cat": "kernel", "ts": 40}]
    assert bench_torch.span_and_busy_ms(events) == (0.031, 0.018)
    assert bench_torch.span_and_busy_ms(events[4:]) == (None, None)


def test_launch_counters_name_every_wrapper():
    # The counters the bench reads: one per kernel, each its wrapper's own.
    from poseidon_tpu_torch import ops
    from poseidon_tpu_torch.ops import mlp, window_attention

    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0} and len(ops.COUNTERS) == 16
    window_attention.window_attention_bwd.launches += 2
    mlp.mlp.launches_general += 1
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {"window_attention_bwd": 2,
                                                      "mlp_general_fwd": 1}
    ops.reset_launch_counts()
    assert not any(ops.launch_counts().values())


def test_bench_without_cuda_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", BENCH_SKIP_L="1", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"metric"' not in res.stdout and res.stdout.strip() == ""
    assert "CUDA" in res.stderr
