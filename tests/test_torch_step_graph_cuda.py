"""``train_step``'s CUDA graph (``poseidon_tpu_torch/training/step_graph.py``)
on the card, on ScOT-T at the bench's configuration through the
hand-written kernels, with a cosine schedule over a few steps (the LR moves
at every step) and a clip below the gradient norm (every step clips):

- five calls on a rotating pool of three batches (the eager first step, the
  capture, three replays) give the bits of five eager steps of a
  capturable optimizer with device LRs: losses, norms, parameters, AdamW's
  state and LRs; each call returns its own loss tensor; no gradient is
  held after a call;
- from the same weights, the first step's update is within the optimizer
  tests' 1e-6 of the default AdamW's, and the five losses close to its;
- another batch shape, or ``optimizer.load_state_dict``, starts a new key:
  an eager step, a new capture, and the steps stay those of the eager
  reference;
- ``loss_fn``, ``group``, ``generator`` and a call inside an outer capture
  (``bench_torch.GraphStep``) step eagerly, as ``graph_counts`` records;
- deleting the optimizer frees the graph and gives its pool back;
- a ``remat`` model captures, and replays the eager reference's bits; a
  model with drop-path and no generator steps eagerly.

They skip without a card. This file imports neither JAX nor the JAX
package:

    python -m pytest tests/test_torch_step_graph_cuda.py -m cuda --noconftest -q
"""

import copy
import gc
import sys
import weakref
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench_torch  # noqa: E402
import poseidon_tpu_torch as pt  # noqa: E402
from poseidon_tpu_torch.tracing import graph_counts  # noqa: E402
from poseidon_tpu_torch.training import step_graph  # noqa: E402

pytestmark = pytest.mark.cuda

BATCH = 4
CLIP = 1e-4
TOTAL_STEPS = 8


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the kernels have no CPU mode)")


def _setup(batch=BATCH, n=3, **overrides):
    cfg = bench_torch.bench_config("T", **overrides)
    model = pt.build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    opt, sched = pt.build_optimizer(model, learning_rate=1e-3, total_steps=TOTAL_STEPS,
                                    weight_decay=1e-6, lr_scheduler_type="cosine",
                                    warmup_ratio=0.0)
    batches = [bench_torch.make_batch(cfg, batch, "cuda", seed=s) for s in range(n)]
    return cfg, model, opt, sched, batches


def _reference(capturable=True):
    """The eager reference: the same weights, each call passed a generator
    (unused at zero dropout), which keeps it eager."""
    _, model, opt, sched, _ = _setup()
    if capturable:
        step_graph.make_capturable(opt, next(model.parameters()).device)

    def step(batch):
        return pt.train_step(model, opt, sched, batch, max_grad_norm=CLIP,
                             generator=torch.Generator("cuda"))
    return model, opt, step


def _delta(before, after):
    return {"captures": after["captures"] - before["captures"],
            "replays": after["replays"] - before["replays"],
            **{r: after["eager"][r] - before["eager"][r] for r in after["eager"]
               if after["eager"][r] != before["eager"][r]}}


def _assert_same_state(m1, o1, m2, o2):
    for (name, p), q in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), name
        assert p.grad is None
        s1, s2 = o1.state[p], o2.state[q]
        assert s1.keys() == s2.keys()
        for k in s1:
            assert torch.equal(s1[k], s2[k]), (name, k)
    for g1, g2 in zip(o1.param_groups, o2.param_groups):
        assert torch.equal(g1["lr"], g2["lr"])


def test_replays_equal_eager_capturable_steps():
    _needs_card()
    from poseidon_tpu_torch import ops

    _, model, opt, sched, batches = _setup()
    ref_model, ref_opt, ref_step = _reference()
    before = graph_counts()
    ops.reset_launch_counts()
    got, want = [], []
    for i in range(5):
        got.append(pt.train_step(model, opt, sched, batches[i % 3], max_grad_norm=CLIP))
        want.append(ref_step(batches[i % 3]))
    torch.cuda.synchronize()
    assert _delta(before, graph_counts()) == {"captures": 1, "replays": 4, "first": 1,
                                              "generator": 5}
    # The conditional norms run their kernels, on both sides: ten steps'
    # worth, the replays' counted from the capture.
    counts = ops.launch_counts()
    assert counts["cond_layer_norm_fwd"] > 0
    assert counts["cond_layer_norm_fwd"] == counts["cond_layer_norm_bwd"]
    assert counts["cond_layer_norm_fwd"] % 10 == 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g["loss"], w["loss"]), i
        assert torch.equal(g["grad_norm"], w["grad_norm"]), i
        assert float(g["grad_norm"]) > CLIP
    assert len({g["loss"].data_ptr() for g in got}) == 5
    assert len({float(g["loss"]) for g in got}) == 5
    _assert_same_state(model, opt, ref_model, ref_opt)
    assert all(torch.is_tensor(g["lr"]) and g["lr"].is_cuda for g in opt.param_groups)
    assert all(isinstance(b, float) for b in sched.base_lrs)


def test_steps_stay_within_default_adamw_tolerance():
    _needs_card()
    _, model, opt, sched, batches = _setup()
    ref_model, _, ref_step = _reference(capturable=False)
    w0 = [p.detach().clone() for p in model.parameters()]
    losses, ref_losses = [], []
    for i in range(5):
        losses.append(float(pt.train_step(model, opt, sched, batches[i % 3],
                                          max_grad_norm=CLIP)["loss"]))
        ref_losses.append(float(ref_step(batches[i % 3])["loss"]))
        if i == 0:
            # The same gradients: the two updates differ by rounding only.
            assert losses[0] == ref_losses[0]
            for p, q in zip(model.parameters(), ref_model.parameters()):
                torch.testing.assert_close(p, q, atol=1e-6, rtol=1e-6)
    assert losses == pytest.approx(ref_losses, rel=1e-3)
    change = sum(float((p.detach() - w).norm() ** 2)
                 for p, w in zip(model.parameters(), w0)) ** 0.5
    gap = sum(float((p.detach() - q.detach()).norm() ** 2)
              for p, q in zip(model.parameters(), ref_model.parameters())) ** 0.5
    print(f"five steps: losses {losses} vs default AdamW {ref_losses}; "
          f"parameter gap {gap:.3e} of a change {change:.3e}")
    assert gap <= 1e-2 * change


def test_new_shape_and_loaded_state_capture_again():
    _needs_card()
    cfg, model, opt, sched, batches = _setup()
    small = [bench_torch.make_batch(cfg, 2, "cuda", seed=s) for s in (5, 6)]
    ref_model, ref_opt, ref_step = _reference()
    before = graph_counts()
    for batch in (batches[0], batches[1], batches[2], small[0], small[1], small[0]):
        out = pt.train_step(model, opt, sched, batch, max_grad_norm=CLIP)
        assert torch.equal(out["loss"], ref_step(batch)["loss"])
    assert _delta(before, graph_counts()) == {"captures": 2, "replays": 4, "first": 2,
                                              "generator": 6}
    _assert_same_state(model, opt, ref_model, ref_opt)

    # The same values in new tensors: a new key, so an eager step, a capture.
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    before = graph_counts()
    for batch in (small[1], small[0], small[1]):
        out = pt.train_step(model, opt, sched, batch, max_grad_norm=CLIP)
        assert torch.equal(out["loss"], ref_step(batch)["loss"])
    assert _delta(before, graph_counts()) == {"captures": 1, "replays": 2, "first": 1,
                                              "generator": 3}
    _assert_same_state(model, opt, ref_model, ref_opt)


def test_ineligible_calls_step_eagerly(tmp_path):
    _needs_card()
    import torch.distributed as dist

    cfg, model, opt, sched, batches = _setup()
    b = batches[0]

    def loss_fn(m, batch):
        return pt.forward_with_loss(m, batch["pixel_values"], batch["time"], batch["labels"],
                                    batch["pixel_mask"])[0]

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        before = graph_counts()
        for kw in (dict(loss_fn=loss_fn), dict(group=dist.group.WORLD),
                   dict(generator=torch.Generator("cuda"))):
            for _ in range(3):
                pt.train_step(model, opt, sched, b, max_grad_norm=CLIP, **kw)
        assert _delta(before, graph_counts()) == {"captures": 0, "replays": 0, "loss_fn": 3,
                                                  "group": 3, "generator": 3}
    finally:
        dist.destroy_process_group()
    assert opt not in step_graph._GRAPHS

    _, model, opt, sched, batches = _setup()
    before = graph_counts()
    outer = bench_torch.GraphStep(model, opt, sched, batches[0], warmup=1)
    for _ in range(2):
        outer()
    torch.cuda.synchronize()
    assert _delta(before, graph_counts()) == {"captures": 0, "replays": 0, "generator": 1,
                                              "capturing": 1}
    assert opt not in step_graph._GRAPHS


def test_deleting_the_optimizer_frees_the_graph():
    _needs_card()
    gc.collect()
    torch.cuda.empty_cache()
    _, model, opt, sched, batches = _setup(batch=32, n=1)
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved()
    for _ in range(3):
        out = pt.train_step(model, opt, sched, batches[0], max_grad_norm=CLIP)
    torch.cuda.synchronize()
    graph = weakref.ref(step_graph._GRAPHS[opt])
    taken = torch.cuda.memory_reserved() - held
    state = sum(v.numel() * v.element_size() for s in opt.state.values() for v in s.values())
    del opt, sched, out
    gc.collect()
    torch.cuda.empty_cache()
    assert graph() is None
    left = torch.cuda.memory_reserved() - held
    print(f"reserved over the model: {taken / 2**20:.1f} MiB with the graph, "
          f"{left / 2**20:.1f} MiB after (AdamW's state {state / 2**20:.1f} MiB)")
    assert taken > 4 * state
    assert left <= 0.1 * taken


def test_remat_captures_and_masks_step_eagerly():
    _needs_card()
    _, model, opt, sched, batches = _setup()
    ref_model, ref_opt, ref_step = _reference()
    model.remat = ref_model.remat = True
    before = graph_counts()
    for i in range(4):
        out = pt.train_step(model, opt, sched, batches[i % 3], max_grad_norm=CLIP)
        assert torch.equal(out["loss"], ref_step(batches[i % 3])["loss"]), i
    assert _delta(before, graph_counts()) == {"captures": 1, "replays": 3, "first": 1,
                                              "generator": 4}
    _assert_same_state(model, opt, ref_model, ref_opt)

    # Drop-path without a generator draws its masks on the host.
    _, model, opt, sched, batches = _setup(drop_path_rate=0.1)
    before = graph_counts()
    losses = [float(pt.train_step(model, opt, sched, batches[i % 3], max_grad_norm=CLIP)["loss"])
              for i in range(3)]
    assert _delta(before, graph_counts()) == {"captures": 0, "replays": 0, "masks": 3}
    assert all(torch.isfinite(torch.tensor(losses)))
