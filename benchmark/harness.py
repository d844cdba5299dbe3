"""One run of a cell: set-up, the measured window, the traced calls, the
check, the result.

Set-up builds the port's model, loads the weights made from the seed,
makes the input pool, and warms up on the cell's own shapes: a training
cell takes its first three steps there, through the same call the window
makes, and keeps what the check compares; a rollout cell runs two
rollouts. The window then calls the same object in a closed loop (each call
issued when the previous one returns) until ``seconds`` have passed, and
ends on a synchronize. A traced run keeps the host time of each call in
the window, then profiles a few more calls. Once the window has closed and
the memory peak is read, the program's state is freed and the reference
judges what the program produced.

Across ranks (``ranks.Ranks``) every rank does all of that in lockstep on
its own card: the ranks agree the window's number of steps (the slowest
rank's last warm-up step into ``seconds``), open it on a barrier, and close
it on a synchronize and a barrier; each profiles its own calls. Then each
frees its state and sends its readings, memory peak and busy time to rank
0, which alone runs the reference and gets the result.
"""

from __future__ import annotations

import gc
import math
import random
import sys
import time
from typing import List, Optional

import torch

from . import check, inputs, trace as tr
from .counts import affine
from .reference import train as ref_train
from .reference.precision import PRECISIONS
from .reference.scot import Reference

SCOT_FIELDS = ("image_size", "patch_size", "num_channels", "num_out_channels", "embed_dim",
               "depths", "num_heads", "skip_connections", "window_size", "mlp_ratio",
               "qkv_bias", "hidden_dropout_prob", "attention_probs_dropout_prob",
               "drop_path_rate", "hidden_act", "use_absolute_embeddings", "layer_norm_eps", "p",
               "channel_slice_list_normalized_loss", "residual_model", "use_conditioning",
               "learn_residual")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(pt, config: dict):
    m, prog = config["model"], config["program"]
    return pt.ScOTConfig(**{k: m[k] for k in SCOT_FIELDS},
                         attention_impl=prog["attention_impl"], score_dtype=prog["score_dtype"],
                         fused_block_tail=prog["fused_block_tail"])


class _Loop:
    """What the window calls: ``call(i)`` runs request or step ``i``."""

    def __init__(self, cell, device, fault: Optional[str]):
        import poseidon_tpu_torch as pt

        self.pt, self.cell, self.device, self.fault = pt, cell, device, fault
        self.t0 = time.perf_counter()
        self.model_cfg = cell.config["model"]
        self.traffic = cell.traffic
        self.batch = self.traffic["batch"]
        cfg = program_config(pt, cell.config)
        with torch.device(device):
            self.model = pt.ScOT(cfg, dtype=DTYPES[cell.config["program"]["compute_dtype"]])
        self.model.to(device)

    def load_weights(self, seed: int) -> None:
        weights = inputs.make_weights(self.model_cfg, seed, self.device,
                                      self.cell.config["init_std"])
        _note("weights made", self.t0)
        self.model.load_state_dict(weights)
        del weights
        _note("weights loaded", self.t0)

    def pool(self, seed: int) -> list:
        return inputs.make_pool(self.model_cfg, self.traffic, seed, self.device)

    def free(self) -> None:
        for name in ("model", "net", "trainer", "optimizer", "scheduler", "inputs"):
            if hasattr(self, name):
                delattr(self, name)


class TrainLoop(_Loop):
    """``poseidon_tpu_torch.train_step`` on the model, its 4-group AdamW
    from ``build_optimizer``, the traffic's clip."""

    kind = "train"

    def __init__(self, cell, device, fault=None):
        super().__init__(cell, device, fault)
        self.model.train()
        self.items_per_call = self.batch
        self.flops_per_call = affine(cell.config["flops"]["train_step"], self.batch)

    def load(self, seed: int) -> None:
        self.load_weights(seed)
        self.net, self.group = self.wrap()
        o = self.traffic["optimizer"]
        self.optimizer, self.scheduler = self.pt.build_optimizer(
            self.model, learning_rate=o["learning_rate"], total_steps=o["total_steps"],
            weight_decay=o["weight_decay"], lr_scheduler_type="cosine", warmup_ratio=0.0,
            adam_beta1=o["betas"][0], adam_beta2=o["betas"][1], adam_epsilon=o["eps"])
        if self.fault == "unchanged":
            self.optimizer.step = lambda *a, **k: None
        _note("optimizer built", self.t0)
        self.inputs = self.pool(seed)

    def call(self, i: int):
        batch = self.inputs[i % len(self.inputs)]
        if self.fault == "half_batch":
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return self.pt.train_step(self.net, self.optimizer, self.scheduler, batch,
                                  max_grad_norm=self.traffic["max_grad_norm"], group=self.group)

    def wrap(self):
        """(what the steps call, the data group): the model itself, none."""
        return self.model, None

    def warm(self, seed: int) -> dict:
        """The first steps, which the check compares: each step's loss and
        gradient norm, the first gradient by leaf as AdamW holds it, and
        each leaf's change after the last of them. ``step_s``: the last
        step's seconds to its loss on the host."""
        losses, norms, first = [], [], {}
        beta1 = self.traffic["optimizer"]["betas"][0]
        for i in range(self.traffic["check_steps"]):
            t = time.perf_counter()
            out = self.call(i)
            losses.append(float(out["loss"]))
            self.step_s = time.perf_counter() - t
            norms.append(float(out["grad_norm"]))
            if i == 0:
                state = self.optimizer.state
                first = {n: (float(state[p]["exp_avg"].norm()) / (1.0 - beta1)
                             if p in state else 0.0)
                         for n, p in self.model.named_parameters()}
        w0 = inputs.make_weights(self.model_cfg, seed, self.device, self.cell.config["init_std"])
        with torch.no_grad():
            change = {n: float((p - w0[n]).norm()) for n, p in self.model.named_parameters()}
        del w0
        self.start = self.traffic["check_steps"]
        return {"losses": losses, "grad_norms": norms, "first_grad": first, "change": change}

    def finish(self, kept: list) -> int:
        """Steps of the window whose loss is not finite."""
        return int((~torch.isfinite(torch.stack(kept))).sum()) if kept else 0

    def keep(self, i: int, out) -> torch.Tensor:
        return out["loss"]

    def reference(self, seed: int, readings: dict) -> dict:
        ref = reference_train_readings(self.cell, seed, self.device)
        return check.train_numbers(readings, ref)


def _no_exchange(state, bucket):
    """A DDP communication hook that exchanges nothing: each rank steps on
    its own gradient (the fault ``no_exchange``)."""
    done = torch.futures.Future()
    done.set_result(bucket.buffer())
    return done


class TrainDDPLoop(TrainLoop):
    """``TrainLoop`` on each rank of the process group, as the port's
    ``Trainer`` runs it under data parallelism: the model wrapped by the
    Trainer itself (``DistributedDataParallel`` over the data group,
    ``broadcast_buffers=False``, ``static_graph=True``, BatchNorm over the
    group), each step ``train_step(..., group=)`` on this rank's shard of
    a global batch of ``batch`` rows a rank."""

    def __init__(self, cell, device, fault=None):
        import torch.distributed as dist

        super().__init__(cell, device, fault)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.items_per_call = self.batch * self.world

    def wrap(self):
        n = self.batch * self.world
        self.trainer = self.pt.Trainer(
            self.model, self.pt.TrainingArguments(train_batch_size=n, eval_batch_size=n),
            device=self.device, mesh=self.pt.parallel.make_mesh(device_type=self.device.type))
        if self.fault == "no_exchange":
            self.trainer.net.register_comm_hook(None, _no_exchange)
        return self.trainer.net, self.trainer.data_group

    def pool(self, seed: int) -> list:
        return inputs.make_pool(self.model_cfg, self.traffic, seed, self.device, self.rank)

    def reference(self, seed: int, readings: List[dict]) -> dict:
        """Every rank's readings against the reference's steps on the
        global batches; each number the worst rank's."""
        ref = reference_train_readings(self.cell, seed, self.device)
        return check.worst([check.train_numbers(r, ref) for r in readings])


class RolloutLoop(_Loop):
    """``poseidon_tpu_torch.autoregressive_rollout`` of the model's eval
    forward under ``torch.inference_mode()``, every step's state returned;
    one rollout of ``batch`` trajectories a request."""

    kind = "rollout"

    def __init__(self, cell, device, fault=None):
        super().__init__(cell, device, fault)
        self.model.eval()
        self.ar_steps = self.traffic["ar_steps"]
        self.items_per_call = self.batch * self.ar_steps
        self.flops_per_call = self.ar_steps * affine(cell.config["flops"]["forward"], self.batch)

    def load(self, seed: int) -> None:
        self.load_weights(seed)
        self.inputs = self.pool(seed)
        self.sample: List[tuple] = []     # (pool index, host copy) of sampled requests
        self.rng = random.Random(inputs.subseed(seed, 3))
        self.seen = 0

    def step_fn(self, x, t):
        if self.fault == "unchanged":
            return x[:, : self.model_cfg["num_out_channels"]].clone()
        if self.fault == "half_batch":
            half = self.model(x[: x.shape[0] // 2], t[: t.shape[0] // 2])
            return torch.cat([half, half])[: x.shape[0]]
        return self.model(x, t)

    def call(self, i: int):
        b = self.inputs[i % len(self.inputs)]
        with torch.inference_mode():
            out = self.pt.autoregressive_rollout(
                self.step_fn, b["pixel_values"], b["time"], self.ar_steps,
                self.model_cfg["num_out_channels"], output_all_steps=True, device=self.device)
            if self.fault == "altered":
                out[0].neg_()
        return out

    def warm(self, seed: int) -> dict:
        """The warm-up rollouts, and the host buffers that the sampled
        requests' outputs are copied to (page-locked where there is a card),
        so that the check's sample holds no device memory."""
        for i in range(self.traffic["warmup_calls"]):
            out = self.call(i)
        pin = self.device.type == "cuda"
        self.host = [torch.empty(out.shape, dtype=out.dtype, pin_memory=pin)
                     for _ in range(self.traffic["check_requests"])]
        self.start = self.traffic["warmup_calls"]
        return {}

    def keep(self, i: int, out) -> torch.Tensor:
        """Reservoir sampling over the window's requests, drawn from the
        seed: ``check_requests`` of them, each equally likely. A request
        drawn is copied to a host buffer on the device's stream."""
        k = self.traffic["check_requests"]
        self.seen += 1
        slot = len(self.sample) if len(self.sample) < k else self.rng.randrange(self.seen)
        if slot < k:
            self.host[slot].copy_(out, non_blocking=True)
            item = (i % len(self.inputs), self.host[slot])
            if slot == len(self.sample):
                self.sample.append(item)
            else:
                self.sample[slot] = item
        with torch.inference_mode():
            return torch.isfinite(out).all()

    def finish(self, kept: list) -> int:
        return int((~torch.stack(kept)).sum()) if kept else 0

    def reference(self, seed: int, readings: dict) -> dict:
        return reference_rollout_numbers(self.cell, seed, self.sample, self.device)


LOOPS = {"train": TrainLoop, "rollout": RolloutLoop, "train_ddp": TrainDDPLoop}


def _reference(cell, precision: str) -> Reference:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Reference(cell.config["model"], PRECISIONS[precision]())


def reference_train_readings(cell, seed: int, device, precision: str = "fp32") -> dict:
    """The reference's first steps on the global batches of the pool (on
    the cell's ``chips`` ranks)."""
    model, traffic = cell.config["model"], cell.traffic
    ref = _reference(cell, precision)
    w0 = inputs.make_weights(model, seed, device, cell.config["init_std"])
    params = {k: v.clone() for k, v in w0.items()}
    batches = [inputs.global_batch(model, traffic, seed, i, device, cell.chips)
               for i in range(traffic["check_steps"])]
    out = ref_train.train_steps(ref, params, batches, traffic["optimizer"],
                                traffic["max_grad_norm"], traffic["reference_rows"])
    out["change"] = {k: float((params[k] - w0[k]).norm()) for k in params}
    return out


def reference_rollout_numbers(cell, seed: int, sample: List[tuple], device) -> dict:
    """The worst ``state_gap`` of the sampled requests' outputs against the
    float32 reference's rollouts of the same inputs."""
    model, traffic = cell.config["model"], cell.traffic
    ref = _reference(cell, "fp32")
    params = inputs.make_weights(model, seed, device, cell.config["init_std"])
    gap = 0.0
    for index, out in sample:
        b = inputs.make_batch(model, traffic, seed, index, device)
        want = ref_train.rollout(ref, params, b["pixel_values"], b["time"], traffic["ar_steps"],
                                 traffic["reference_rows"])
        gap = max(gap, check.state_gap(out.to(device), want))
    return {"state_gap": gap if sample else float("inf")}


def rollout_control(cell, seed: int, device, precision: str = "fp8") -> dict:
    """The control in the program's place: the reference at ``precision``
    over the same requests, judged against the float32 reference."""
    model, traffic = cell.config["model"], cell.traffic
    low = _reference(cell, precision)
    params = inputs.make_weights(model, seed, device, cell.config["init_std"])
    sample = []
    for index in range(traffic["check_requests"]):
        b = inputs.make_batch(model, traffic, seed, index, device)
        sample.append((index, ref_train.rollout(low, params, b["pixel_values"], b["time"],
                                                traffic["ar_steps"], traffic["reference_rows"])))
    return reference_rollout_numbers(cell, seed, sample, device)


def train_control(cell, seed: int, device, precision: str = "fp8") -> dict:
    low = reference_train_readings(cell, seed, device, precision)
    ref = reference_train_readings(cell, seed, device)
    return check.train_numbers(low, ref)


def window(loop, seconds: float, spans: bool, steps: Optional[int] = None, ranks=None):
    """Calls in a closed loop until ``seconds`` have passed, or ``steps``
    calls where the ranks agreed a number; ends on a synchronize, and a
    barrier across ``ranks``. Returns (seconds, calls, host seconds of each
    call or None, the calls' kept values)."""
    host: List[float] = []
    kept = []
    calls = 0
    t0 = time.perf_counter()
    while True:
        i = loop.start + calls
        a = time.perf_counter()
        out = loop.call(i)
        b = time.perf_counter()
        host.append(b - a)
        kept.append(loop.keep(i, out))
        calls += 1
        if (b - t0 >= seconds) if steps is None else calls == steps:
            break
    if loop.device.type == "cuda":
        torch.cuda.synchronize(loop.device)
    if ranks is not None:
        ranks.barrier()
    return time.perf_counter() - t0, calls, (host if spans else None), kept


def _note(what: str, t0: float) -> None:
    print(f"# {time.perf_counter() - t0:.3f} s: {what}", file=sys.stderr, flush=True)


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device=None,
        fault: Optional[str] = None, ranks=None) -> Optional[dict]:
    """One run of ``cell``: what the result line is made of; across
    ``ranks``, on rank 0, and None on the others."""
    device = torch.device(device if device is not None else "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    loop = LOOPS[cell.traffic["loop"]](cell, device, fault)
    _note("model built", t0)
    loop.load(seed)
    _note("weights and inputs made", t0)
    readings = loop.warm(seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    steps = None
    if ranks is not None:
        step_s = ranks.max(loop.step_s)
        steps = max(1, math.ceil(seconds / step_s))
        _note(f"{steps} steps agreed (slowest warm-up step {step_s:.4f} s)", t0)
        ranks.barrier()
    setup_s = time.perf_counter() - t0
    _note("warm-up done", t0)
    win_s, calls, host, kept = window(loop, seconds, trace, steps, ranks)
    failed = loop.finish(kept)
    del kept
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    prof = None
    launches = None
    if trace:
        counts = loop.pt.ops.launch_counts()
        n = cell.traffic["profile_calls"]
        start = loop.start + calls
        prof = tr.profile(lambda i: loop.call(start + i), n, device)
        after = loop.pt.ops.launch_counts()
        launches = {k: (after[k] - counts[k]) / n for k in after if after[k] != counts[k]}
    loop.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    busy = [prof["busy_s"]] if prof else []
    if ranks is not None:
        every = ranks.gather({"readings": readings, "peak": peak,
                              "busy_s": prof["busy_s"] if prof else None})
        if every is None:
            return None
        readings = [e["readings"] for e in every]
        peak = max(e["peak"] for e in every)
        busy = [e["busy_s"] for e in every if e["busy_s"] is not None]
    t_ref = time.perf_counter()
    numbers = loop.reference(seed, readings)
    _note(f"reference judged in {time.perf_counter() - t_ref:.3f} s", t0)
    ctx = {"cell": cell.name, "kind": loop.kind, "config": cell.config,
           "traffic": cell.traffic, "batch": cell.traffic["batch"], "setup_s": setup_s,
           "peak_bytes": peak,
           "window": {"seconds": win_s, "calls": calls, "items": loop.items_per_call * calls,
                      "host_call_s": host},
           "flops_per_call": loop.flops_per_call, "profile": prof}
    return {"ctx": ctx, "numbers": numbers, "attempted": calls, "failed": failed,
            "launches": launches, "busy_s": sum(busy) / len(busy) if busy else None}


def breakdown(prof: dict) -> dict:
    return {"device_ops": tr.top(prof["kernels"].items()), "idle_gaps": tr.top(prof["gaps"])}
