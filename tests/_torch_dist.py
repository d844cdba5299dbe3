"""Runs a function in N processes joined in one ``torch.distributed`` group,
for the port's multi-process tests (torch only: no JAX, so it also runs on
the card's machine).

    procs = start_ranks("_torch_dist:ddp_trial", 2, tmp_path, out=...)
    results = procs.results()        # one return value per rank

starts the processes (this file as the program, each with its own rank),
joined by a ``file://`` rendezvous in ``tmp_path`` over gloo. Each calls
the named function of a module on the tests' path with the keyword
arguments given (passed and returned through ``torch.save`` files), then
leaves the group. ``results`` waits for every process, at most
``timeout`` seconds each; a process that fails or is still running then
fails the call and every process is killed, so that a hang fails one test
and not the suite.

The trials below are the functions the tests run in the processes, with the
datasets they share with the one-process runs.
"""

from __future__ import annotations

import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent


class Ranks:
    def __init__(self, procs, outs, timeout):
        self.procs, self.outs, self.timeout = procs, outs, timeout

    def results(self):
        logs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=self.timeout)
                logs.append(out)
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError(f"a rank ran past {self.timeout} s:\n" + "\n".join(logs))
        for rank, (p, log) in enumerate(zip(self.procs, logs)):
            if p.returncode != 0:
                self.kill()
                raise AssertionError(f"rank {rank} failed (rc {p.returncode}):\n{log[-6000:]}")
        return [torch.load(o, weights_only=False) for o in self.outs]

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def start_ranks(target: str, world: int, tmp, timeout: float = 120, **kwargs) -> Ranks:
    """Start ``world`` processes running ``target`` ("module:function")."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    init = tmp / "rendezvous"
    init.unlink(missing_ok=True)
    args = tmp / "kwargs.pt"
    torch.save(kwargs, args)
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}{TESTS}", OMP_NUM_THREADS="1")
    procs, outs = [], []
    for rank in range(world):
        out = tmp / f"rank{rank}.pt"
        out.unlink(missing_ok=True)
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, target, str(rank), str(world), str(init), str(args),
             str(out)], env=env, cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return Ranks(procs, outs, timeout)


def run_ranks(target: str, world: int, tmp, timeout: float = 120, **kwargs):
    return start_ranks(target, world, tmp, timeout, **kwargs).results()


def _main():
    target, rank, world, init, args, out = sys.argv[1:]
    import torch.distributed as dist

    torch.set_num_threads(1)
    module, fn = target.split(":")
    fn = getattr(importlib.import_module(module), fn)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=int(rank),
                            world_size=int(world))
    try:
        result = fn(**torch.load(args, weights_only=False))
    finally:
        dist.destroy_process_group()
    torch.save(result, out)


# ---------------------------------------------------------------------------
# Datasets and trials
# ---------------------------------------------------------------------------

class DecayDataset:
    """``tests/_multihost_worker.py::run_trial``'s dataset: label = input
    with channel 0 decayed by exp(-t), deterministic per index."""

    resolution = 16
    input_dim = 2
    output_dim = 2
    channel_slice_list = [0, 1, 2]
    printable_channel_description = ["u", "c"]

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(1000 + i)
        x = rng.normal(size=(2, 16, 16)).astype(np.float32)
        t = np.float32(0.1 + 0.8 * (i % 7) / 7)
        y = x.copy()
        y[0] = x[0] * np.exp(-t)
        return {"pixel_values": x, "labels": y, "time": t}


# run_trial's model config (fp32, dropout off)
TRIAL_CONFIG = dict(image_size=16, patch_size=2, num_channels=2, num_out_channels=2,
                    embed_dim=16, depths=(1, 1), num_heads=(2, 2), skip_connections=(1, 0),
                    window_size=4, mlp_ratio=2.0, channel_slice_list=(0, 1, 2),
                    use_conditioning=True)
TRIAL_ARGS = dict(train_batch_size=8, eval_batch_size=8, num_train_epochs=2, learning_rate=1e-3,
                  weight_decay=1e-6, compute_dtype="float32", num_workers=2, logging_steps=1,
                  save_total_limit=2)
N_TRAIN, N_EVAL = 16, 13   # the last eval batch: 5 valid rows of 8


def trainer(out, config, state, n_train=N_TRAIN, n_eval=N_EVAL, device="cpu", **kw):
    """The port's Trainer on DecayDataset with the trial's arguments, the
    model's weights set from ``state``."""
    import poseidon_tpu_torch as pt

    model = pt.ScOT(pt.ScOTConfig.from_dict(config))
    model.load_state_dict(state)
    ds = DecayDataset(n_train)
    metrics = pt.ChannelGroupMetrics(ds.channel_slice_list, ds.printable_channel_description)
    return pt.Trainer(model, pt.TrainingArguments(output_dir=str(out), **{**TRIAL_ARGS, **kw}),
                      train_dataset=ds, eval_dataset=DecayDataset(n_eval) if n_eval else None,
                      compute_metrics=metrics, device=device)


def _cpu(sd):
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def train_run(out, config, state, resume_from=None, **kw):
    """``Trainer.train`` (optionally resumed from the checkpoints of
    ``resume_from``, copied into ``out``), then the predictions of the eval
    set: what the tests compare across world sizes."""
    from poseidon_tpu_torch.parallel.host import is_primary, sync_hosts

    if resume_from is not None:
        if is_primary():
            shutil.copytree(resume_from, out)
        sync_hosts()
    t = trainer(out, config, state, **kw)
    history = t.train(resume_from_checkpoint=resume_from is not None)
    preds, labels, loss = t._predict_arrays(t.eval_dataset)
    return {"history": history, "preds": preds, "labels": labels, "pred_loss": loss,
            "model": _cpu(t.model_state_dict()), "step": t.step}


def one_step(config, state, batch, device="cpu", ar_steps=None, **kw):
    """One ``Trainer._train_step`` on this rank's rows of a global batch
    (all of it in one process): loss, grad norm, the model after the
    step."""
    import tempfile

    from poseidon_tpu_torch.ops import mlp, window_attention as wa
    from poseidon_tpu_torch.parallel.mesh import shard_batch

    t = trainer(tempfile.mkdtemp(), config, state, n_eval=0, device=device, **kw)
    if t.mesh is not None:
        batch = shard_batch(batch, t.mesh)
    if ar_steps is not None:
        t.set_ar_steps(ar_steps)
    counters = [(wa.window_attention, "launches"), (wa.window_attention_bwd, "launches"),
                (wa.window_attention, "launches_general"),
                (wa.window_attention_bwd, "launches_general"), (mlp.mlp, "launches"),
                (mlp.mlp_bwd, "launches"), (mlp.mlp, "launches_general"),
                (mlp.mlp_bwd, "launches_general")]
    before = [getattr(f, a) for f, a in counters]
    dev = {k: torch.as_tensor(v).to(t.device) for k, v in batch.items()}
    out = t._train_step(dev, 0)
    names = ("window_attention_fwd", "window_attention_bwd", "window_attention_general_fwd",
             "window_attention_general_bwd", "mlp_fwd", "mlp_bwd", "mlp_general_fwd",
             "mlp_general_bwd")
    launches = {n: getattr(f, a) - b for n, (f, a), b in zip(names, counters, before)}
    return {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
            "model": _cpu(t.model_state_dict()), "launches": launches}


def mesh_trial():
    """make_mesh's shapes, indices and error, shard_batch's rows and
    gather_rows on this rank."""
    import torch.distributed as dist

    from poseidon_tpu_torch.parallel.mesh import gather_rows, make_mesh, shard_batch

    batch = {"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3), "t": np.arange(8.0)}
    out = {}
    for key, args in (("default", (None, 1)), ("model2", (None, 2)), ("data2", (2, 1)),
                      ("data1", (1, 2))):
        m = make_mesh(*args, device_type="cpu")
        out[key] = {"shape": dict(zip(m.mesh_dim_names, m.mesh.shape)),
                    "data": m.get_local_rank("data"), "model": m.get_local_rank("model"),
                    "rows": shard_batch(batch, m)}
    try:
        make_mesh(3, 1, device_type="cpu")
    except ValueError as e:
        out["error"] = str(e)
    out["gathered"] = gather_rows(torch.full((3, 2), float(dist.get_rank())), None)
    return out


def naive_loss(config, state, batch):
    """The loss a per-rank normaliser would give: each rank's ``scot_loss``
    of its rows alone, averaged over the ranks (what plain DDP of the
    one-process loss trains on)."""
    import torch.distributed as dist

    import poseidon_tpu_torch as pt
    from poseidon_tpu_torch.parallel.mesh import make_mesh, shard_batch

    cfg = pt.ScOTConfig.from_dict(config)
    model = pt.ScOT(cfg)
    model.load_state_dict(state)
    b = {k: torch.as_tensor(v) for k, v in shard_batch(batch, make_mesh(device_type="cpu")).items()}
    with torch.no_grad():
        loss = pt.scot_loss(model(b["pixel_values"], b["time"]), b["labels"], cfg)
    dist.all_reduce(loss)
    return float(loss) / dist.get_world_size()


def dropout_draws(config, state):
    """Draws from the Trainer's step-5 generator, and the prediction of one
    fixed input under dropout with it."""
    import tempfile

    t = trainer(tempfile.mkdtemp(), config, state, n_eval=0)
    x = torch.as_tensor(DecayDataset(1)[0]["pixel_values"])[None]
    t.model.train()
    pred = t.model(x, torch.full((1,), 0.5), generator=t._generator(5))
    return {"draws": torch.rand(4, generator=t._generator(5)), "pred": pred.detach()}


def ddp_suite(root, config, state, resume_from, scale_batch, bn_config, bn_state, bn_batch,
              unused_config, unused_state, dropout_config):
    """Every two-rank run of tests/test_torch_ddp.py, in one start of the
    processes."""
    return {"train": train_run(f"{root}/train", config, state),
            "resumed": train_run(f"{root}/resumed", config, state, resume_from=resume_from),
            "scale": one_step(config, state, scale_batch),
            "naive": naive_loss(config, state, scale_batch),
            "bn": one_step(bn_config, bn_state, bn_batch, ar_steps=2, learning_rate=1e-4),
            "unused": one_step(unused_config, unused_state, scale_batch),
            "dropout": dropout_draws(dropout_config, state)}


def hsdp_moments(config, state):
    """``assert_opt_state_sharded`` after one HSDP step (tensors of 2^8
    elements and more: the toy model has none of 2^16), and its error on
    moments that are not DTensors."""
    import tempfile

    from poseidon_tpu_torch.parallel.mesh import assert_opt_state_sharded, make_mesh

    t = trainer(tempfile.mkdtemp(), config, state, n_eval=0, num_model_shards=2)
    batch = {k: torch.as_tensor(np.stack([DecayDataset(8)[i][k] for i in range(8)]))
             for k in ("pixel_values", "labels", "time")}
    t._train_step(batch, 0)
    out = {"checked": assert_opt_state_sharded(t.optimizer, t.mesh, min_size=2**8)}
    plain = torch.nn.Linear(64, 64)
    opt = torch.optim.AdamW(plain.parameters())
    plain(torch.ones(1, 64)).sum().backward()
    opt.step()
    try:
        assert_opt_state_sharded(opt, make_mesh(1, 2, device_type="cpu"), min_size=2**8)
    except AssertionError as e:
        out["error"] = str(e)
    return out


def fsdp_suite(root, config, state, resume_from, **kw):
    """Every two-rank run of tests/test_torch_fsdp.py: HSDP (1 x 2) and DDP
    (2 x 1) training, HSDP resumed from a one-process checkpoint (``kw``:
    their arguments), and the sharded moments."""
    return {"hsdp": train_run(f"{root}/hsdp", config, state, num_model_shards=2, **kw),
            "ddp": train_run(f"{root}/ddp", config, state, **kw),
            "resumed": train_run(f"{root}/resumed", config, state, resume_from=resume_from,
                                 num_model_shards=2, **kw),
            "moments": hsdp_moments(config, state)}


if __name__ == "__main__":
    _main()
