"""ScOT's forward graph (``poseidon_tpu_torch/models/forward_graph.py``) on
the card, on ScOT-T at the bench's configuration through the hand-written
kernels, in bf16 and in fp32 (the general kernels):

- no-grad calls on a rotating pool of three batches (the eager first call,
  the capture, replays, the last two in another memory layout) give the
  eager body's bits, each its own tensor, and count the kernels' launches
  as the eager body launches them;
- ``autoregressive_rollout`` under ``inference_mode`` gives the same bits
  graphed and eager;
- ``load_state_dict`` in place is read by the next replay, and ``.to()``
  (new parameter tensors) starts a new key;
- alternating ``no_grad`` and ``inference_mode`` calls, and ``time=None``,
  give the eager bits;
- a one-off batch shape runs eagerly and leaves the graph in place;
- ``train_step``'s capture and replays are unchanged: its forwards run with
  autograd and take the eager body; a no-grad forward inside an outer
  capture runs the eager body into it;
- deleting the model frees the graph and gives its pool back, and keeps
  nothing on the card that a second model adds to;
- a dead reference cycle that holds another graph is not collected inside
  a capture (the forward's or the train step's), where destroying that
  graph would fail the capture;
- ``Trainer.predict`` and ``Trainer.evaluate`` capture and replay while the
  Trainer's prefetch thread copies the next batch to the card, give the
  eager body's bits, and training after them releases the graph and its
  pool.

They skip without a card. This file imports neither JAX nor the JAX
package:

    python -m pytest tests/test_torch_forward_graph_cuda.py -m cuda --noconftest -q -s
"""

import gc
import sys
import threading
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench_torch  # noqa: E402
import poseidon_tpu_torch as pt  # noqa: E402
from poseidon_tpu_torch import ops  # noqa: E402
from poseidon_tpu_torch.models import forward_graph  # noqa: E402
from poseidon_tpu_torch.tracing import forward_graph_counts, graph_counts  # noqa: E402
from poseidon_tpu_torch.training import step_graph  # noqa: E402

pytestmark = pytest.mark.cuda

BATCH = 4
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the kernels have no CPU mode)")


def _setup(dtype=torch.bfloat16, batch=BATCH, n=3, seed=0):
    cfg = bench_torch.bench_config("T")
    model = pt.build_model(cfg, device="cuda", dtype=dtype, seed=seed)
    inputs = [bench_torch.make_batch(cfg, batch, "cuda", seed=s) for s in range(n)]
    return cfg, model, [(b["pixel_values"], b["time"]) for b in inputs]


def _delta(before, after):
    return {"captures": after["captures"] - before["captures"],
            "replays": after["replays"] - before["replays"],
            **{r: after["eager"][r] - before["eager"][r] for r in after["eager"]
               if after["eager"][r] != before["eager"][r]}}


@torch.no_grad()
def _eager(model, x, t):
    return model.eager_forward(x, t)


def _graph_pool_bytes() -> int:
    """Bytes the allocator holds in CUDA graphs' private pools."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))


@pytest.mark.parametrize("dtype", DTYPES)
def test_replays_give_the_eager_bits_and_launches(dtype):
    _needs_card()
    _, model, inputs = _setup(DTYPES[dtype])
    want = [_eager(model, x, t) for x, t in inputs]
    ops.reset_launch_counts()
    _eager(model, *inputs[0])
    per_forward = {k: v for k, v in ops.launch_counts().items() if v}
    assert per_forward
    ops.reset_launch_counts()
    before = forward_graph_counts()
    got = []
    with torch.no_grad():
        for i in range(6):
            x, t = inputs[i % 3]
            if i >= 4:   # the layout a rollout feeds back: not in the key
                x = x.contiguous(memory_format=torch.channels_last)
            got.append(model(x, t))
    torch.cuda.synchronize()
    assert _delta(before, forward_graph_counts()) == {"captures": 1, "replays": 5, "first": 1}
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        k: 6 * v for k, v in per_forward.items()}
    for i, g in enumerate(got):
        assert torch.equal(g, want[i % 3]), i
    assert len({g.data_ptr() for g in got}) == 6
    graph = forward_graph._GRAPHS[model]
    print(f"ScOT-T {dtype} b{BATCH}: {_graph_pool_bytes() / 2**20:.1f} MiB in the graph's pool")
    assert all(g.data_ptr() != graph.out.data_ptr() for g in got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rollout_gives_the_same_bits_graphed_and_eager(dtype):
    _needs_card()
    _, model, inputs = _setup(DTYPES[dtype])
    x, t = inputs[0]
    before = forward_graph_counts()
    with torch.inference_mode():
        got = pt.autoregressive_rollout(model, x, t, 5, 4, output_all_steps=True,
                                        device="cuda")
        want = pt.autoregressive_rollout(model.eager_forward, x, t, 5, 4,
                                         output_all_steps=True, device="cuda")
    assert _delta(before, forward_graph_counts()) == {"captures": 1, "replays": 4, "first": 1}
    assert torch.equal(got, want)


def test_load_state_dict_is_replayed_and_to_starts_a_new_key():
    _needs_card()
    _, model, inputs = _setup()
    _, other, _ = _setup(seed=1)
    x, t = inputs[0]
    with torch.no_grad():
        model(x, t)
        model(x, t)
        model.load_state_dict(other.state_dict())
        before = forward_graph_counts()
        assert torch.equal(model(x, t), _eager(other, x, t))
        assert _delta(before, forward_graph_counts()) == {"captures": 0, "replays": 1}
        model.to("cpu").to("cuda")
        before = forward_graph_counts()
        for x, t in inputs:
            assert torch.equal(model(x, t), _eager(other, x, t))
    assert _delta(before, forward_graph_counts()) == {"captures": 1, "replays": 2, "first": 1}


def test_no_grad_inference_mode_and_no_time_alternate():
    _needs_card()
    _, model, inputs = _setup()
    x, t = inputs[0]
    want, want_no_time = _eager(model, x, t), _eager(model, x, None)
    modes = [torch.no_grad, torch.no_grad, torch.inference_mode, torch.no_grad,
             torch.inference_mode, torch.inference_mode, torch.no_grad, torch.inference_mode]
    before = forward_graph_counts()
    for i, mode in enumerate(modes):
        with mode():
            assert torch.equal(model(x, t), want), i
            assert torch.equal(model(x, None), want_no_time), i
    counts = _delta(before, forward_graph_counts())
    assert counts["first"] + counts["replays"] == 2 * len(modes)
    # Each call's key differs from the one before: nothing is captured.
    assert counts["captures"] == 0
    with torch.no_grad():
        for _ in range(3):
            assert torch.equal(model(x, None), want_no_time)
    assert _delta(before, forward_graph_counts())["captures"] == 1


def test_one_off_shape_leaves_the_graph():
    _needs_card()
    cfg, model, inputs = _setup()
    odd = bench_torch.make_batch(cfg, 3, "cuda", seed=7)
    odd = (odd["pixel_values"], odd["time"])
    before = forward_graph_counts()
    with torch.no_grad():
        for x, t in (inputs[0], inputs[1], odd, inputs[2], odd, inputs[0]):
            assert torch.equal(model(x, t), _eager(model, x, t))
    assert _delta(before, forward_graph_counts()) == {"captures": 1, "replays": 3, "first": 3}
    assert forward_graph._GRAPHS[model].key == forward_graph.forward_key(model, *inputs[0])


def test_train_step_is_unchanged():
    _needs_card()
    cfg, model, _ = _setup()
    _, ref, _ = _setup()
    opts = [pt.build_optimizer(m, learning_rate=1e-3, total_steps=8, weight_decay=1e-6,
                               lr_scheduler_type="cosine", warmup_ratio=0.0)
            for m in (model, ref)]
    step_graph.make_capturable(opts[1][0], torch.device("cuda"))
    batches = [bench_torch.make_batch(cfg, BATCH, "cuda", seed=s) for s in range(3)]
    steps, fwd = graph_counts(), forward_graph_counts()
    for i in range(5):
        out = pt.train_step(model, *opts[0], batches[i % 3], max_grad_norm=1e-4)
        want = pt.train_step(ref, *opts[1], batches[i % 3], max_grad_norm=1e-4,
                             generator=torch.Generator("cuda"))
        assert torch.equal(out["loss"], want["loss"]), i
    assert _delta(steps, graph_counts()) == {"captures": 1, "replays": 4, "first": 1,
                                             "generator": 5}
    # The forwards of the eager steps and the capture ran with autograd.
    assert _delta(fwd, forward_graph_counts()) == {"captures": 0, "replays": 0, "grad": 7}
    assert model not in forward_graph._GRAPHS
    # One side stream a device serves the train step's graph and the
    # forward's.
    assert step_graph._GRAPHS[opts[0][0]].stream is forward_graph.side_stream(
        torch.device("cuda"))

    # A no-grad forward inside an outer capture runs the eager body into it.
    model.eval()
    x, t = batches[0]["pixel_values"], batches[0]["time"]
    want = _eager(model, x, t)
    graph = torch.cuda.CUDAGraph()
    fwd = forward_graph_counts()
    with torch.no_grad(), torch.cuda.graph(graph):
        out = model(x, t)
    graph.replay()
    torch.cuda.synchronize()
    assert _delta(fwd, forward_graph_counts()) == {"captures": 0, "replays": 0, "capturing": 1}
    assert torch.equal(out, want)


def test_deleting_the_model_frees_the_graph():
    _needs_card()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held, pools = torch.cuda.memory_reserved(), _graph_pool_bytes()
    left = []
    for _ in range(2):
        _, model, inputs = _setup(batch=32, n=1)
        with torch.no_grad():
            for _ in range(3):
                out = model(*inputs[0])
        torch.cuda.synchronize()
        graph = weakref.ref(forward_graph._GRAPHS[model])
        pool = _graph_pool_bytes() - pools
        taken = torch.cuda.memory_reserved() - held
        del model, out, inputs
        gc.collect()
        torch.cuda.empty_cache()
        assert graph() is None
        assert pool > 0 and _graph_pool_bytes() == pools
        left.append(torch.cuda.memory_reserved() - held)
        print(f"ScOT-T bf16 b32: {pool / 2**20:.1f} MiB in the graph's pool, "
              f"{taken / 2**20:.1f} MiB reserved with the model, "
              f"{left[-1] / 2**20:.1f} MiB after deleting it")
    # The side stream's first use may keep its cuBLAS workspace for the
    # process (one a device); a second model keeps nothing more.
    assert left[1] == left[0]


class _Holder:
    """A reference cycle, dead once its last outside reference goes."""

    def __init__(self, graph):
        self.graph, self.me = graph, self


@pytest.mark.parametrize("path", ["forward", "train_step"])
def test_a_dead_cycle_holding_a_graph_waits_for_the_capture_to_end(path, monkeypatch):
    _needs_card()
    cfg, model, inputs = _setup()
    x, t = inputs[0]
    static = torch.zeros(8, device="cuda")
    other = torch.cuda.CUDAGraph()
    with torch.cuda.graph(other):
        static.add_(1)
    pending, dead, alive = [other], [], []
    del other
    body = model.eager_forward

    def eager_forward(*args, **kwargs):
        if pending and torch.cuda.is_current_stream_capturing():
            # Inside the capture the graph's last reference turns into a
            # dead cycle, and enough allocations follow for the collector
            # to run, were it allowed to.
            dead.append(weakref.ref(_Holder(pending.pop())))
            junk = [[] for _ in range(10 * gc.get_threshold()[0])]
            del junk
            alive.append(dead[-1]() is not None)
        return body(*args, **kwargs)

    monkeypatch.setattr(model, "eager_forward", eager_forward)
    if path == "forward":
        want = _eager(model, x, t)
        before = forward_graph_counts()
        with torch.no_grad():
            got = [model(x, t) for _ in range(3)]
        assert _delta(before, forward_graph_counts()) == {"captures": 1, "replays": 2,
                                                          "first": 1}
        assert all(torch.equal(g, want) for g in got)
    else:
        opt, sched = pt.build_optimizer(model, learning_rate=1e-3, total_steps=8,
                                        weight_decay=1e-6, lr_scheduler_type="cosine",
                                        warmup_ratio=0.0)
        batch = bench_torch.make_batch(cfg, BATCH, "cuda", seed=0)
        before = graph_counts()
        for _ in range(3):
            pt.train_step(model, opt, sched, batch, max_grad_norm=1e-4)
        assert _delta(before, graph_counts()) == {"captures": 1, "replays": 2, "first": 1}
    torch.cuda.synchronize()
    assert alive == [True]
    gc.collect()
    assert dead[0]() is None


class _Samples:
    """``n`` samples at ``cfg``'s shapes, as the Trainer's loader reads a
    dataset: inputs and labels N(0, 1), lead times in [0.1, 1)."""

    def __init__(self, cfg, n, seed=0):
        rng = np.random.default_rng(seed)
        shape = (n, cfg.num_channels, cfg.image_size, cfg.image_size)
        self.x = rng.standard_normal(shape, dtype=np.float32)
        self.y = rng.standard_normal((n, cfg.num_out_channels) + shape[2:], dtype=np.float32)
        self.t = rng.uniform(0.1, 1.0, n).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"pixel_values": self.x[i], "labels": self.y[i], "time": self.t[i]}


def _eager_predictions(model, ds, batch):
    """The eager body's predictions of ``ds`` in the loader's evaluation
    batches (the last padded with its last sample), the padding cut."""
    out = []
    for i in range(0, len(ds), batch):
        rows = [min(j, len(ds) - 1) for j in range(i, i + batch)]
        x, t = torch.from_numpy(ds.x[rows]).cuda(), torch.from_numpy(ds.t[rows]).cuda()
        out.append(_eager(model, x, t)[: len(ds) - i].float().cpu().numpy())
    return np.concatenate(out)


def test_trainer_evaluates_under_the_graph_while_it_copies_the_next_batch(tmp_path,
                                                                          monkeypatch):
    _needs_card()
    gc.collect()
    torch.cuda.empty_cache()
    pools = _graph_pool_bytes()
    cfg, model, _ = _setup()
    ds = _Samples(cfg, 4 * BATCH + 1)   # five batches, the last padded
    args = pt.TrainingArguments(output_dir=str(tmp_path), train_batch_size=BATCH,
                                eval_batch_size=BATCH, num_train_epochs=1, learning_rate=1e-3,
                                max_grad_norm=5.0, logging_steps=1, num_workers=2)
    trainer = pt.Trainer(model, args, train_dataset=ds, device="cuda")

    # The second batch's forward captures; the prefetch thread's copy of the
    # third batch waits until that capture has begun, and the capture until
    # the copy has been issued, so the two run at once.
    started, copied = threading.Event(), threading.Event()
    capture = forward_graph._ForwardGraph.capture

    def capture_while_copying(self, inputs, fn):
        def body(static):
            started.set()
            assert copied.wait(60)
            return fn(static)
        return capture(self, inputs, body)

    device_batch, threads = trainer._device_batch, []

    def copy_during_capture(batch):
        threads.append(threading.current_thread())
        if len(threads) == 3:
            assert started.wait(60)
        out = device_batch(batch)
        if len(threads) == 3:
            copied.set()
        return out

    monkeypatch.setattr(forward_graph._ForwardGraph, "capture", capture_while_copying)
    monkeypatch.setattr(trainer, "_device_batch", copy_during_capture)
    before = forward_graph_counts()
    out = trainer.predict(ds)
    assert started.is_set() and copied.is_set()
    assert threading.current_thread() not in threads
    assert _delta(before, forward_graph_counts()) == {"captures": 1, "replays": 4, "first": 1}
    want = _eager_predictions(model, ds, BATCH)
    assert out.predictions.shape == want.shape and np.array_equal(out.predictions, want)

    before = forward_graph_counts()
    metrics = trainer.evaluate(ds)
    assert _delta(before, forward_graph_counts()) == {"captures": 0, "replays": 5}
    assert metrics["loss"] == out.metrics["loss"]

    # Training goes on: the change to train mode releases the graph, and
    # the allocator gives its pool back.
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    history = trainer.train()
    assert model not in forward_graph._GRAPHS
    assert np.isfinite(history[-1]["train_loss"])
    assert any(not torch.equal(p, weights[n]) for n, p in model.named_parameters())
    gc.collect()
    torch.cuda.empty_cache()
    assert _graph_pool_bytes() == pools

    # The trained weights: a new capture, the eager body's bits.
    before = forward_graph_counts()
    out = trainer.predict(ds)
    assert _delta(before, forward_graph_counts()) == {"captures": 1, "replays": 4, "first": 1}
    assert np.array_equal(out.predictions, _eager_predictions(model, ds, BATCH))
    trainer.close()
