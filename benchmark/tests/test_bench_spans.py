"""The span reduction (``benchmark/spans.py``) on a hand-written Chrome
trace, and the MLP's bound at one stage by hand.

The trace: two train steps 120 us apart, each the same. The main thread
(tid 1) opens the step, its phases and one block's three parts, runs
``WindowAttentionFn`` and an ``aten::mm`` (sequence numbers 10 and 11,
each the start of a ``fwdbwd`` flow) and launches four kernels in the
forward and two in the optimizer; autograd's thread (tid 2) runs the two
backward ops at the flows' ends and an ``AccumulateGrad`` with no flow,
each launching one kernel, the first through the CUDA driver API. The
profiler lost the record of one kernel of the first step. Times in us:

    forward 0-40: attention 5-15, norm 15-20, mlp 20-30
        launches 7 (attention), 16 (norm), 22 (mlp), 32 and 33.5 (no part;
        the second an empty kernel, lost in the first step)
    backward 40-70, on tid 2: 46 (MmBackward0 -> mlp),
        57 (WindowAttentionFnBackward -> attention), 68 (no flow)
    optimizer 70-95: 75, 80 (a memset)
"""

import pytest

from benchmark import spans as sp
from benchmark import trace
from benchmark.tests.test_bench_counts import B, TOY

# (correlation, launch time, launch thread, device start, duration, name)
OPS = [(1, 7, 1, 8, 10, "window_attention_fwd_kernel<256, 32>"),
       (2, 16, 1, 18, 2, "vectorized_elementwise_kernel<4>"),
       (3, 22, 1, 23, 4, "mlp_fwd_kernel<96>"),
       (4, 32, 1, 33, 1, "vectorized_elementwise_kernel<4>"),
       (5, 46, 2, 47, 5, "nvjet_tst_128x64_64x8_1x2_h_bz_NNT"),
       (6, 57, 2, 58, 8, "attn_bwd_kernel<256, 32>"),
       (7, 68, 2, 68, 1, "vectorized_elementwise_kernel<4>"),
       (8, 75, 1, 76, 10, "multi_tensor_apply_kernel<AdamW>"),
       (9, 80, 1, 86, 1, "Memset (Device)"),
       (10, 33.5, 1, 34, 0, "vectorized_elementwise_kernel<4>")]


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _flow(ph, ident, tid, ts):
    return {"ph": ph, "cat": "fwdbwd", "name": "fwdbwd", "id": ident, "pid": 1, "tid": tid,
            "ts": ts}


def _step(t0, corr0):
    ua = "user_annotation"
    ev = [_x(ua, "scot.train_step", 1, t0, 100), _x(ua, "scot.forward", 1, t0, 40),
          _x(ua, "scot.block.attention", 1, t0 + 5, 10), _x(ua, "scot.block.norm", 1, t0 + 15, 5),
          _x(ua, "scot.block.mlp", 1, t0 + 20, 10), _x(ua, "scot.backward", 1, t0 + 40, 30),
          _x(ua, "scot.optimizer", 1, t0 + 70, 25),
          _x(ua, "Optimizer.step#AdamW.step", 1, t0 + 74, 10),
          _x("cpu_op", "WindowAttentionFn", 1, t0 + 6, 8, **{"Sequence number": 10 + corr0,
                                                              "Fwd thread id": 0}),
          _x("cpu_op", "aten::mm", 1, t0 + 21, 4, **{"Sequence number": 11 + corr0,
                                                     "Fwd thread id": 0}),
          _flow("s", 10 + corr0, 1, t0 + 6), _flow("s", 11 + corr0, 1, t0 + 21),
          _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 2, t0 + 45, 10,
             **{"Sequence number": 11 + corr0, "Fwd thread id": 1}),
          _x("cpu_op", "MmBackward0", 2, t0 + 45.5, 8.5,
             **{"Sequence number": 11 + corr0, "Fwd thread id": 1}),
          _x("cpu_op", "WindowAttentionFnBackward", 2, t0 + 56, 10,
             **{"Sequence number": 10 + corr0, "Fwd thread id": 1}),
          _x("cpu_op", "autograd::engine::evaluate_function: torch::autograd::AccumulateGrad",
             2, t0 + 67, 2),
          _flow("f", 11 + corr0, 2, t0 + 45.5), _flow("f", 10 + corr0, 2, t0 + 56)]
    for corr, launch, tid, start, dur, name in OPS:
        c = corr + corr0
        api = ("cuda_driver", "cuLaunchKernel") if corr == 5 else \
            ("cuda_runtime", "cudaMemsetAsync" if corr == 9 else "cudaLaunchKernel")
        ev.append(_x(api[0], api[1], tid, t0 + launch, 0.5, correlation=c))
        if corr == 10 and t0 == 0:
            continue                    # the profiler lost this device op's record
        cat = "gpu_memset" if corr == 9 else "kernel"
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": t0 + start,
                   "dur": dur, "args": {"correlation": c, "stream": 7}})
    return ev


EVENTS = _step(0.0, 0) + _step(120.0, 100)
US = 1e-6


def test_reduce_spans_by_hand():
    got = sp.reduce_spans(EVENTS)
    assert got["calls"] == 2 and got["launches"] == [10, 10] and got["dropped"] == 1
    assert got["spans"] == 7
    assert got["device_s"] == pytest.approx(42 * US)
    assert got["phase_device_s"] == pytest.approx(
        {"forward": 17 * US, "backward": 14 * US, "optimizer": 11 * US})
    assert got["part_device_s"] == {
        "attention": pytest.approx({"attention": 18 * US}),
        "norm": pytest.approx({"other": 2 * US}),
        "mlp": pytest.approx({"mlp": 4 * US, "gemm": 5 * US}),
        "none": pytest.approx({"other": 3 * US, "optimizer": 10 * US})}
    # Holes: 20-23, 27-33 (forward), 34-47, 52-58, 66-68 (backward), 69-76
    # (optimizer), and 87-128 between the steps, once for two calls.
    assert got["idle_s"] == pytest.approx(
        {"forward": 9 * US, "backward": 21 * US, "optimizer": 7 * US, "between calls": 20.5 * US})
    assert sp.checks(got) == pytest.approx(
        {"phase_share": 1.0, "attention_in_part": 1.0, "mlp_in_part": 1.0})


def test_figures_by_hand():
    f = sp.figures(sp.reduce_spans(EVENTS), "train", TOY, B)
    assert f == pytest.approx({
        "forward_device_ms.train": 17e-3, "backward_device_ms.train": 14e-3,
        "optimizer_device_ms.train": 11e-3, "forward_idle_ms.train": 9e-3,
        "backward_idle_ms.train": 21e-3, "optimizer_idle_ms.train": 7e-3,
        "norm_device_ms.train": 2e-3, "attention_other_device_ms.train": 0.0,
        "mlp_roofline.train": 100 * sp.mlp_s(TOY, B, True) / (9 * US),
        "launches.train": 10.0})
    r = sp.figures(sp.reduce_spans(EVENTS), "rollout", TOY, B, ar_steps=7)
    assert set(r) == {"norm_device_ms.rollout", "attention_other_device_ms.rollout",
                      "mlp_roofline.rollout", "launches.rollout"}
    assert r["mlp_roofline.rollout"] == pytest.approx(
        100 * 7 * sp.mlp_s(TOY, B, False) / (9 * US))


def test_no_call_span_reads_nothing():
    plain = [e for e in EVENTS if not e["name"].startswith("scot.")]
    assert sp.reduce_spans(plain) is None
    assert sp.figures(None, "train", TOY, B) == {}


def test_spans_leave_reduce_trace_as_it_was():
    plain = [e for e in EVENTS if e.get("cat") not in ("user_annotation", "fwdbwd")]
    with_spans, without = trace.reduce_trace(EVENTS), trace.reduce_trace(plain)
    assert with_spans == without
    assert with_spans["busy_s"] == pytest.approx(2 * 42 * US)


def test_mlp_bound_by_hand():
    # One stage of 8 x 8 tokens at width 8, F = 32; encoder and decoder, two
    # blocks each.
    m, c, f = B * 64, 8, 32
    flops = 4 * m * c * f
    params = (2 * c * f + f + c) * 4
    fwd = max(flops / 989e12, (2 * m * c * 2 + params) / 3.35e12)
    bwd = max(2 * flops / 989e12, (3 * m * c * 2 + 2 * c * f * 4 + params) / 3.35e12)
    assert sp.mlp_s(TOY, B, False) == pytest.approx(4 * fwd, rel=1e-12)
    assert sp.mlp_s(TOY, B, True) == pytest.approx(4 * (fwd + bwd), rel=1e-12)
