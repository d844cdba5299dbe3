"""The Trainer: ``poseidon_tpu.training.trainer.Trainer`` in PyTorch, on one
card (or the CPU when the caller asks for it), or one process per card
under ``torchrun`` over the (data, model) mesh of ``parallel/mesh.py``.

- ``train``: epochs over the deterministic loader, the train step, the
  epoch's ``train_loss`` summed on the device, delayed step logging (the
  metrics of a logging window are read one window later, so the host does
  not wait for the device at every step), evaluation every
  ``eval_every_epochs``, keep-best into ``best/``, epoch checkpoints
  ``checkpoint-E`` and mid-epoch ones ``checkpoint-E-stepN``, at most
  ``save_total_limit`` of them, early stopping with a threshold, and the
  best weights loaded at the end.
- ``evaluate``: streaming per-sample metrics where ``compute_metrics`` has
  ``per_sample``, the padded last batch masked out of the loss.
- ``predict``: predictions, labels and metrics, with the ``ar_step_{i}/``
  battery under ``output_all_steps``.
- Randomness: the dropout and drop-path masks of global step s come from a
  ``torch.Generator`` on the device seeded from (seed, s) (and the rollout
  step index in AR training), in place of ``jax.random.fold_in``. With the
  deterministic loader, a run resumed from a checkpoint takes the steps the
  uninterrupted run took. Under data parallelism the data index joins the
  seed, so that the ranks draw different masks for their different rows:
  the masks (never equal to JAX's anyway) then differ from a one-process
  run's; with dropout and drop-path off a data-parallel run computes what
  one process does at the same global batch.
- Checkpoints are ``torch.save`` of state dicts (model with its BatchNorm
  buffers, optimizer, scheduler), the step, the epoch's loss sum and meta
  (epoch, best metric, batch index), written by process 0, with a barrier
  after every write. A checkpoint is written under a temporary name and
  renamed into place, so a partial write is never taken for one. Under FSDP
  the full state is gathered to process 0 first, in the same format, so a
  checkpoint resumes at any world size.
- Data parallelism (a process group started, e.g. by
  ``parallel.initialize_distributed``): the ``(data, model)`` mesh of
  ``num_model_shards``; ``DistributedDataParallel`` over ``data`` when the
  model axis is 1, else FSDP2 ``fully_shard`` per ``SwinBlock`` and at the
  root over the 2-D mesh (HSDP). Each rank loads its rows of every global
  batch. The loss is each rank's share of the global batch's loss
  (``scot_loss(..., group=)``), BatchNorm's statistics are the global
  batch's, evaluation gathers every rank's predictions, and the logged
  losses and norms are the global ones.
- The host-to-device copy of batch N+1 (pinned memory, a side stream) runs
  while step N computes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..data.loader import DataLoader
from ..models.layers import BatchNorm
from ..models.scot import ScOT, SwinBlock, apply_pixel_mask, forward_with_loss, scot_loss
from ..parallel.host import is_primary, process_count, sync_hosts
from ..parallel.mesh import gather_rows, make_mesh
from ..tracing import span
from ..utils.device import resolve_device
from .arguments import TrainingArguments
from .optimizer import build_optimizer, clip_by_global_norm, global_norm
from .rollout import autoregressive_rollout_stateful

LossFn = Callable[[ScOT, Mapping[str, torch.Tensor]], torch.Tensor]

CHECKPOINT_FILE = "state.pt"


def _direct_loss(model: ScOT, batch: Mapping[str, torch.Tensor],
                 generator: Optional[torch.Generator], group=None) -> torch.Tensor:
    return forward_with_loss(model, batch["pixel_values"], batch.get("time"), batch["labels"],
                             batch.get("pixel_mask"), generator=generator, group=group)[0]


def _data_size(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def train_step(model: ScOT, optimizer: torch.optim.Optimizer,
               scheduler: torch.optim.lr_scheduler.LRScheduler,
               batch: Mapping[str, torch.Tensor], *, max_grad_norm: Optional[float],
               generator: Optional[torch.Generator] = None,
               loss_fn: Optional[LossFn] = None, group=None) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``batch`` (``pixel_values``, ``labels``, and
    optionally ``time`` and ``pixel_mask``), with the model in train mode:
    the loss (by default the direct branch: forward with dropout and
    drop-path masks from ``generator``, BatchNorm running statistics
    updating -> ``apply_pixel_mask`` -> ``scot_loss``; ``loss_fn(model,
    batch)`` in its place, as the Trainer's AR branch) -> backward -> global
    norm of the gradients -> clip by it (when ``max_grad_norm`` is set and
    positive) -> ``optimizer.step()`` -> ``scheduler.step()`` -> gradients
    set to None. Returns the loss and the norm before clipping, as device
    tensors (reading them synchronises): what ``Trainer._train_step``
    returns in the JAX package.

    ``group``: the data axis's process group, when ``batch`` is this
    process's rows of a global batch split over it (``model`` wrapped in
    DDP, or sharded by FSDP). The loss (``loss_fn``'s, which must then be
    ``scot_loss(..., group=group)``'s share) is backpropagated times the
    group's size, so that the mean DDP and FSDP take over the processes is
    the sum of the shares' gradients: the gradient of the global batch's
    loss. The loss returned is the sum of the shares, the global loss."""
    with span("train_step"):
        model.train()
        n = _data_size(group)
        with span("forward"):
            loss = (_direct_loss(model, batch, generator, group) if loss_fn is None
                    else loss_fn(model, batch))
        with span("backward"):
            (loss * n if n > 1 else loss).backward()
        with span("optimizer"):
            params = [p for p in model.parameters() if p.requires_grad]
            if max_grad_norm is not None and max_grad_norm > 0:
                gnorm = clip_by_global_norm(params, max_grad_norm)
            else:
                gnorm = global_norm(params)
            optimizer.step()
            scheduler.step()
            optimizer.zero_grad(set_to_none=True)
        loss = loss.detach()
        if n > 1:
            dist.all_reduce(loss, group=group)
        return {"loss": loss, "grad_norm": gnorm}


@dataclasses.dataclass
class PredictionOutput:
    """What :meth:`Trainer.predict` returns, as HF's ``PredictionOutput``."""
    predictions: Optional[np.ndarray]
    label_ids: Optional[np.ndarray]
    metrics: Dict[str, float]


def _full_state():
    """Options of a whole state dict gathered to process 0, on the CPU."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions

    return StateDictOptions(full_state_dict=True, cpu_offload=True)


class Trainer:
    """Train, evaluate and predict with a ScOT model; see the module
    docstring. ``device`` defaults to CUDA and raises when there is none
    (pass ``device="cpu"`` for the CPU). ``mesh``: the ``(data, model)``
    mesh (``parallel.make_mesh``); by default, when a process group is
    started, ``make_mesh(num_model=args.num_model_shards)``. The batch
    sizes are global and must divide by the mesh's data size."""

    def __init__(self, model: ScOT, args: TrainingArguments, train_dataset=None,
                 eval_dataset=None,
                 compute_metrics: Optional[Callable[[np.ndarray, np.ndarray], Dict]] = None,
                 device: Optional[Union[str, torch.device]] = None, mesh=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = model.config
        self.args = args
        if mesh is None and process_count() > 1:
            mesh = make_mesh(num_model=args.num_model_shards, device_type=self.device.type)
        self.mesh = mesh
        self._parallelize()
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.compute_metrics = compute_metrics
        self.ar_steps: Union[None, int, Sequence[float]] = None
        self.output_all_steps = False
        self._want_all_steps = False
        self._log_file = None
        self._wandb = None
        self._profiler = None
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.optimizer = self.scheduler = None
        if train_dataset is not None:
            a = args
            self.optimizer, self.scheduler = build_optimizer(
                model, learning_rate=a.learning_rate,
                total_steps=max(self._steps_per_epoch() * a.num_train_epochs, 1),
                weight_decay=a.weight_decay, lr_scheduler_type=a.lr_scheduler_type,
                warmup_ratio=a.warmup_ratio,
                learning_rate_embedding_recovery=a.learning_rate_embedding_recovery,
                learning_rate_time_embedding=a.learning_rate_time_embedding,
                adam_beta1=a.adam_beta1, adam_beta2=a.adam_beta2, adam_epsilon=a.adam_epsilon)
        self.step = 0  # optimizer steps taken
        self.loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)

    # -- setup --------------------------------------------------------------
    def _parallelize(self):
        """Under a mesh: check the batch sizes against its data size, give
        the BatchNorm layers the data group, and wrap the model (DDP over
        ``data`` when the model axis is 1, else FSDP2 over the mesh).
        ``self.net`` is what the steps call (the DDP wrapper, or the model,
        sharded in place by FSDP); ``self.model`` stays the ScOT module."""
        self.net = self.model
        self.data_group, self.data_index, self.sharded = None, 0, False
        mesh = self.mesh
        if mesh is None:
            return
        data_size = mesh["data"].size()
        for name in ("train_batch_size", "eval_batch_size"):
            if getattr(self.args, name) % data_size:
                raise ValueError(f"{name}={getattr(self.args, name)} must be divisible by the "
                                 f"data-parallel mesh size ({data_size} devices)")
        self.data_index = mesh.get_local_rank("data")
        if data_size > 1:
            self.data_group = mesh.get_group("data")
            for m in self.model.modules():
                if isinstance(m, BatchNorm):
                    m.process_group = self.data_group
        if mesh["model"].size() > 1:
            from torch.distributed.fsdp import fully_shard

            for m in self.model.modules():
                if isinstance(m, SwinBlock):
                    fully_shard(m, mesh=mesh)
            fully_shard(self.model, mesh=mesh)
            self.sharded = True
        elif data_size > 1:
            from torch.nn.parallel import DistributedDataParallel

            # BatchNorm's statistics are the global batch's, so its buffers
            # agree on every rank without DDP's broadcast.
            self.net = DistributedDataParallel(
                self.model, device_ids=[self.device] if self.device.type == "cuda" else None,
                process_group=self.data_group, broadcast_buffers=False, static_graph=True)

    def _steps_per_epoch(self) -> int:
        return max(len(self.train_dataset) // self.args.train_batch_size, 1)

    def set_ar_steps(self, ar_steps=None, output_all_steps: Optional[bool] = None):
        """Configure autoregressive prediction and training.
        ``output_all_steps=None`` keeps the previously requested value."""
        self.ar_steps = ar_steps
        if output_all_steps is not None:
            self._want_all_steps = bool(output_all_steps)
        self.output_all_steps = bool(ar_steps is not None and self._want_all_steps)

    def _generator(self, *keys: int) -> torch.Generator:
        """A generator on the device seeded from (seed, *keys), and the data
        index under data parallelism (the ranks hold different rows)."""
        if self.data_group is not None:
            keys = keys + (self.data_index,)
        seed = int(np.random.SeedSequence([self.args.seed, *keys]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- core steps ---------------------------------------------------------
    def _loss_and_pred(self, batch: Mapping[str, torch.Tensor], train: bool,
                       step: Optional[int] = None,
                       sample_weights: Optional[torch.Tensor] = None):
        """(loss, prediction) of ``batch``: the direct branch, or with AR
        steps set the rollout, whose loss is the mean of the per-step losses
        against the final labels. Every rollout step runs in the caller's
        mode; in train mode step i draws its masks from the generator of
        (seed, ``step``, i) and BatchNorm statistics update step after step.
        Under ``output_all_steps`` the prediction is every step's,
        (B, n, C, H, W). Under data parallelism the loss is this rank's
        share of the global batch's (``scot_loss(..., group=)``)."""
        cfg, model, group = self.config, self.net, self.data_group
        model.train(train)
        labels, pixel_mask = batch["labels"], batch.get("pixel_mask")
        if self.ar_steps is not None and batch.get("time") is not None:
            def ar_step(x, t, i, state):
                gen = self._generator(step, i) if train and step is not None else None
                return model(x, t, generator=gen), state

            preds, _ = autoregressive_rollout_stateful(
                ar_step, batch["pixel_values"], batch["time"], self.ar_steps,
                cfg.num_out_channels)
            losses = [scot_loss(apply_pixel_mask(preds[:, i], labels, pixel_mask), labels, cfg,
                                sample_weights=sample_weights, group=group)
                      for i in range(preds.shape[1])]
            loss = torch.stack(losses).mean()
            if self.output_all_steps:
                return loss, preds
            return loss, apply_pixel_mask(preds[:, -1], labels, pixel_mask)
        gen = self._generator(step) if train and step is not None else None
        pred = model(batch["pixel_values"], batch.get("time"), generator=gen)
        pred = apply_pixel_mask(pred, labels, pixel_mask)
        return scot_loss(pred, labels, cfg, sample_weights=sample_weights, group=group), pred

    def _train_step(self, batch: Mapping[str, torch.Tensor],
                    global_step: int) -> Dict[str, torch.Tensor]:
        """One step, its masks drawn from the generator of (seed,
        ``global_step``); the (global) loss joins the epoch's sum on the
        device."""
        out = train_step(self.net, self.optimizer, self.scheduler, batch,
                         max_grad_norm=self.args.max_grad_norm,
                         loss_fn=lambda m, b: self._loss_and_pred(b, True, global_step)[0],
                         group=self.data_group)
        self.loss_sum += out["loss"].float()
        self.step += 1
        return out

    # -- host to device -----------------------------------------------------
    def _device_batch(self, batch: Mapping[str, np.ndarray]):
        """The batch's tensors on the device, without the loader's
        ``_valid`` counts, and the event their copy records (None on the
        CPU). On CUDA the copy is from pinned memory on a side stream."""
        host = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
                if not k.startswith("_valid")}
        if self._copy_stream is None:
            return {k: v.to(self.device) for k, v in host.items()}, None
        with torch.cuda.stream(self._copy_stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return out, done

    def _device_prefetch(self, batches: Iterator[Dict[str, np.ndarray]]):
        """Yield (host batch, device batch) with a one-batch lookahead on a
        background thread, so the copy of batch N+1 overlaps step N."""
        def ready(item):
            batch, (dev, done) = item
            if done is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(done)
                for v in dev.values():
                    v.record_stream(stream)
            return batch, dev

        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = None
            for b in batches:
                nxt = pool.submit(lambda hb: (hb, self._device_batch(hb)), b)
                if fut is not None:
                    yield ready(fut.result())
                fut = nxt
            if fut is not None:
                yield ready(fut.result())

    def _hosts(self) -> Dict[str, int]:
        """The loader's host split: one host per data index (the ranks of a
        model group load the same rows)."""
        return {"num_hosts": _data_size(self.data_group), "host_id": self.data_index}

    # -- loops --------------------------------------------------------------
    def train(self, resume_from_checkpoint: Optional[bool] = None) -> List[Dict]:
        a = self.args
        if resume_from_checkpoint is None:
            resume_from_checkpoint = a.resume_from_checkpoint
        os.makedirs(a.output_dir, exist_ok=True)
        self._open_logging()
        loader = DataLoader(self.train_dataset, a.train_batch_size, shuffle=True, seed=a.seed,
                            drop_last=True, **self._hosts(), num_workers=a.num_workers)
        start_epoch, start_batch = 0, 0
        best_metric = np.inf if not a.greater_is_better else -np.inf
        patience_left = a.early_stopping_patience
        if resume_from_checkpoint:
            restored = self.load_checkpoint(a.output_dir)
            if restored is not None:
                start_epoch, best_metric, start_batch = restored
        steps_per_epoch = self._steps_per_epoch()
        log_every = max(a.logging_steps, 1)
        history = []
        stop = False
        for epoch in range(start_epoch, a.num_train_epochs):
            t_epoch = _time.time()
            resume_bi = start_batch if epoch == start_epoch else 0
            if resume_bi == 0:
                # On a mid-epoch resume the restored sum carries over.
                self.loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            n_running = resume_bi
            # Logging is delayed one window: at each logging point the
            # metrics recorded at the previous one are read (long since
            # computed) and the current step's device scalars are kept.
            pending_log = None
            for bi, (_, dbatch) in enumerate(
                    self._device_prefetch(loader.epoch(epoch, start_batch=resume_bi)),
                    start=resume_bi):
                global_step = epoch * steps_per_epoch + bi
                self._maybe_profile(global_step)
                metrics = self._train_step(dbatch, global_step)
                n_running += 1
                if (bi + 1) % log_every == 0:
                    if pending_log is not None:
                        self._flush_step_log(pending_log)
                    pending_log = {"epoch": epoch, "step": global_step + 1, "metrics": metrics}
                if (a.save_steps is not None and (bi + 1) % a.save_steps == 0
                        and bi + 1 < steps_per_epoch):
                    # Mid-epoch checkpoint; the step log is flushed first so
                    # that logs.jsonl agrees with the checkpoint.
                    if pending_log is not None:
                        self._flush_step_log(pending_log)
                        pending_log = None
                    self.save_checkpoint(a.output_dir, epoch, best_metric, batch_index=bi + 1)
            if pending_log is not None:
                self._flush_step_log(pending_log)
            epoch_metrics = {"epoch": epoch, "train_time_s": _time.time() - t_epoch,
                             "train_loss": float(self.loss_sum) / max(n_running, 1)}
            if self.eval_dataset is not None and (epoch + 1) % max(a.eval_every_epochs, 1) == 0:
                eval_metrics = self.evaluate()
                epoch_metrics.update({f"eval_{k}": v for k, v in eval_metrics.items()})
                current = epoch_metrics.get(f"eval_{a.metric_for_best_model}", np.inf)
                improved = (current < best_metric - a.early_stopping_threshold
                            if not a.greater_is_better
                            else current > best_metric + a.early_stopping_threshold)
                if improved:
                    best_metric = current
                    patience_left = a.early_stopping_patience
                    self.save_checkpoint(a.output_dir, epoch, best_metric, best=True)
                elif a.early_stopping_patience is not None:
                    patience_left -= 1
                    if patience_left <= 0:
                        stop = True
            if (epoch + 1) % max(a.save_every_epochs, 1) == 0 or stop \
                    or epoch == a.num_train_epochs - 1:
                self.save_checkpoint(a.output_dir, epoch, best_metric, best=False)
            self.log(epoch_metrics)
            history.append(epoch_metrics)
            if stop:
                break
        self._stop_profile()
        if a.load_best_model_at_end and self.eval_dataset is not None:
            self._load_best(a.output_dir)
        return history

    def evaluate(self, dataset=None) -> Dict[str, float]:
        dataset = dataset if dataset is not None else self.eval_dataset
        cm = self.compute_metrics
        if cm is not None and hasattr(cm, "per_sample") and not self.output_all_steps:
            # Streaming: per-sample error vectors only; predictions are
            # never concatenated.
            samples: Dict[str, List[np.ndarray]] = {}
            losses, counts = [], []
            for pred, lab, loss, valid in self._eval_batches(dataset):
                for k, v in cm.per_sample(pred, lab).items():
                    samples.setdefault(k, []).append(v)
                losses.append(loss)
                counts.append(valid)
            out = {"loss": float(np.average(np.asarray(losses), weights=np.asarray(counts)))}
            out.update(cm.from_samples({k: np.concatenate(v) for k, v in samples.items()}))
            return out
        preds, labels, loss = self._predict_arrays(dataset)
        out = {"loss": loss}
        out.update(self._metric_battery(preds, labels))
        return out

    def _eval_batches(self, dataset):
        """Yield per-batch (predictions, labels, loss, valid count) with the
        loader's padding left out: predictions and labels cut to the valid
        count, the loss weighted by it in the step. One batch deep: step N+1
        is queued before step N's values are read."""
        a = self.args
        loader = DataLoader(dataset, a.eval_batch_size, shuffle=False, drop_last=False,
                            **self._hosts(), num_workers=a.num_workers)
        group = self.data_group

        def fetch(loss, pred, labels, valid):
            if group is not None:
                # Every rank gets the whole global batch, in rank order, cut
                # to the global valid count (the JAX package's _to_host).
                pred, labels = gather_rows(pred, group), gather_rows(labels, group).cpu().numpy()
            return pred[:valid].float().cpu().numpy(), labels[:valid], float(loss), valid

        pending = None
        for batch, dbatch in self._device_prefetch(loader.epoch(0)):
            valid = int(batch.get("_valid_global", batch["_valid"]))
            b = dbatch["pixel_values"].shape[0]
            # The rows' indices in the global batch: padding is masked out
            # of the loss on every rank.
            rows = torch.arange(b, device=self.device) + self.data_index * b
            weights = (rows < valid).float()
            with torch.no_grad():
                loss, pred = self._loss_and_pred(dbatch, False, sample_weights=weights)
            if group is not None:
                dist.all_reduce(loss, group=group)
            labels = dbatch["labels"] if group is not None else np.asarray(batch["labels"])
            nxt = (loss, pred, labels, valid)
            if pending is not None:
                yield fetch(*pending)
            pending = nxt
        if pending is not None:
            yield fetch(*pending)

    def _predict_arrays(self, dataset):
        """(predictions, labels, loss), the loader's padding left out; the
        batch losses averaged with their valid counts as weights."""
        preds, labels, losses, counts = [], [], [], []
        for pred, lab, loss, valid in self._eval_batches(dataset):
            preds.append(pred)
            labels.append(lab)
            losses.append(loss)
            counts.append(valid)
        loss = float(np.average(np.asarray(losses), weights=np.asarray(counts)))
        return np.concatenate(preds), np.concatenate(labels), loss

    def _metric_battery(self, preds: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
        """``compute_metrics``, aware of ``output_all_steps`` predictions
        (N, steps, C, H, W): the unprefixed battery is the final step's, and
        each step also gets an ``ar_step_{i}/`` battery against the same
        final-time labels."""
        if self.compute_metrics is None:
            return {}
        if preds.ndim == labels.ndim + 1:
            out = {}
            last = preds.shape[1] - 1
            for si in range(preds.shape[1]):
                step_metrics = self.compute_metrics(preds[:, si], labels)
                for k, v in step_metrics.items():
                    out[f"ar_step_{si}/{k}"] = v
                if si == last:
                    out.update(step_metrics)
            return out
        return dict(self.compute_metrics(preds, labels))

    def predict(self, dataset, metric_key_prefix: str = "",
                return_predictions: bool = True) -> PredictionOutput:
        """A prediction pass (with the AR steps set by :meth:`set_ar_steps`).
        ``return_predictions=False`` streams the metrics instead
        (``predictions`` and ``label_ids`` are None)."""
        cm = self.compute_metrics
        if (not return_predictions and cm is not None and hasattr(cm, "per_sample")
                and not self.output_all_steps):
            metrics = {f"{metric_key_prefix}{k}": v for k, v in self.evaluate(dataset).items()}
            return PredictionOutput(None, None, metrics)
        preds, labels, loss = self._predict_arrays(dataset)
        metrics = {f"{metric_key_prefix}loss": loss}
        for k, v in self._metric_battery(preds, labels).items():
            metrics[f"{metric_key_prefix}{k}"] = v
        return PredictionOutput(preds, labels, metrics)

    # -- checkpointing ------------------------------------------------------
    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's whole state dict (BatchNorm buffers included). Under
        FSDP the shards are gathered: every rank must call it, and process
        0 gets the tensors, on the CPU (the others an empty dict)."""
        if not self.sharded:
            return self.model.state_dict()
        from torch.distributed.checkpoint.state_dict import get_model_state_dict

        return get_model_state_dict(self.model, options=_full_state())

    def _param_names(self) -> List[str]:
        """The parameters' names in the optimizer's order: the numbering of
        ``optimizer.state_dict()``."""
        names = {p: n for n, p in self.model.named_parameters()}
        return [names[p] for g in self.optimizer.param_groups for p in g["params"]]

    def _optimizer_state_dict(self) -> Optional[Dict]:
        """``optimizer.state_dict()``; under FSDP the whole state gathered to
        process 0 (every rank must call it) and numbered as one process
        numbers it, so that a checkpoint resumes at any world size."""
        if self.optimizer is None:
            return None
        if not self.sharded:
            return self.optimizer.state_dict()
        from torch.distributed.checkpoint.state_dict import get_optimizer_state_dict

        osd = get_optimizer_state_dict(self.model, self.optimizer, options=_full_state())
        if not osd:
            return None
        index = {n: i for i, n in enumerate(self._param_names())}
        return {"state": {index[n]: v for n, v in osd["state"].items()},
                "param_groups": [{**g, "params": [index[n] for n in g["params"]]}
                                 for g in osd["param_groups"]]}

    def _load_states(self, model_sd: Dict, optimizer_sd: Optional[Dict] = None):
        """Load a whole state dict (every rank passes the same) into the
        model and, when given, the optimizer; under FSDP each rank keeps its
        shards."""
        if not self.sharded:
            self.model.load_state_dict(model_sd)
            if optimizer_sd is not None:
                self.optimizer.load_state_dict(optimizer_sd)
            return
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, set_model_state_dict, set_optimizer_state_dict)

        opts = StateDictOptions(full_state_dict=True)
        set_model_state_dict(self.model, model_sd, options=opts)
        if optimizer_sd is not None:
            names = self._param_names()
            osd = {"state": {names[i]: v for i, v in optimizer_sd["state"].items()},
                   "param_groups": [{**g, "params": [names[i] for i in g["params"]]}
                                    for g in optimizer_sd["param_groups"]]}
            set_optimizer_state_dict(self.model, self.optimizer, osd, options=opts)

    def _state(self, epoch: int, best_metric: float, batch_index: int = 0) -> Dict:
        return {"model": self.model_state_dict(),
                "optimizer": self._optimizer_state_dict(),
                "scheduler": self.scheduler.state_dict() if self.scheduler else None,
                "step": self.step, "loss_sum": self.loss_sum,
                # batch_index 0: the epoch is complete; > 0: optimizer steps
                # already taken in this epoch (a mid-epoch checkpoint).
                "meta": {"epoch": epoch, "best": float(best_metric), "batch_index": batch_index}}

    @staticmethod
    def _ckpt_sort_key(name: str):
        """Chronological order: within an epoch, ``checkpoint-E-stepN``
        before the boundary ``checkpoint-E``."""
        parts = name.split("-")
        return int(parts[1]), int(parts[2][4:]) if len(parts) > 2 else np.inf

    @staticmethod
    def _list_checkpoints(out_dir: str) -> List[str]:
        """Complete ``checkpoint-*`` directories in chronological order: a
        write that did not finish left only a ``*.tmp-*`` directory, or a
        directory without its state file, and is skipped."""
        if not os.path.isdir(out_dir):
            return []
        return sorted((d for d in os.listdir(out_dir)
                       if d.startswith("checkpoint-") and ".tmp" not in d
                       and os.path.isfile(os.path.join(out_dir, d, CHECKPOINT_FILE))),
                      key=Trainer._ckpt_sort_key)

    @staticmethod
    def _write_dir(path: str, files: Dict[str, Callable[[str], None]]):
        """Write a directory atomically: every file into ``path.tmp-<pid>``,
        then renamed into place (an old directory of that name is removed
        after the rename)."""
        tmp = f"{path}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name, write in files.items():
            write(os.path.join(tmp, name))
        old = None
        if os.path.exists(path):
            old = f"{path}.tmp-old-{os.getpid()}"
            os.replace(path, old)
        os.replace(tmp, path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)

    def save_checkpoint(self, out_dir: str, epoch: int, best_metric: float,
                        best: bool = False, batch_index: int = 0):
        if best:
            name = "best"
        elif batch_index > 0:
            name = f"checkpoint-{epoch}-step{batch_index}"
        else:
            name = f"checkpoint-{epoch}"
        # Under FSDP gathering the state is collective: every rank takes part.
        if is_primary() or self.sharded:
            state = self._state(epoch, best_metric, batch_index)
        if is_primary():
            self._write_dir(os.path.join(out_dir, name),
                            {CHECKPOINT_FILE: lambda p: torch.save(state, p)})
            if not best:
                keep = self.args.save_total_limit
                for d in self._list_checkpoints(out_dir)[:-keep] if keep else []:
                    shutil.rmtree(os.path.join(out_dir, d), ignore_errors=True)
        # No rank reads a checkpoint before process 0 has written it.
        sync_hosts("checkpoint")

    def _read_state(self, path: str) -> Dict:
        return torch.load(os.path.join(path, CHECKPOINT_FILE), map_location=self.device,
                          weights_only=True)

    def load_checkpoint(self, out_dir: str):
        """Restore the latest checkpoint. Returns ``(start_epoch,
        best_metric, start_batch)``; ``start_batch > 0`` resumes in the
        middle of ``start_epoch`` at that batch."""
        cks = self._list_checkpoints(out_dir)
        if not cks:
            return None
        state = self._read_state(os.path.join(out_dir, cks[-1]))
        resume = self.optimizer is not None and state["optimizer"] is not None
        self._load_states(state["model"], state["optimizer"] if resume else None)
        if resume:
            self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])
        self.loss_sum = state["loss_sum"].to(self.device)
        meta = state["meta"]
        if meta["batch_index"] > 0:
            return int(meta["epoch"]), float(meta["best"]), int(meta["batch_index"])
        return int(meta["epoch"]) + 1, float(meta["best"]), 0

    def _load_best(self, out_dir: str):
        path = os.path.join(out_dir, "best")
        if os.path.isfile(os.path.join(path, CHECKPOINT_FILE)):
            self._load_states(self._read_state(path)["model"])

    def save_model(self, out_dir: str):
        """The final weights (``model/state_dict.pt``, with the BatchNorm
        buffers) and ``config.json``, written by process 0; every rank
        calls it."""
        sd = self.model_state_dict()
        if is_primary():
            os.makedirs(out_dir, exist_ok=True)
            sd = {k: v.detach().cpu() for k, v in sd.items()}
            self._write_dir(os.path.join(out_dir, "model"),
                            {"state_dict.pt": lambda p: torch.save(sd, p)})
            with open(os.path.join(out_dir, "config.json"), "w") as f:
                f.write(self.config.to_json())
        sync_hosts("save_model")

    # -- profiling ----------------------------------------------------------
    def _maybe_profile(self, global_step: int):
        """A ``torch.profiler`` trace of steps [profile_step_start,
        profile_step_stop) (three steps when no stop is given) into
        ``output_dir/profile``."""
        a = self.args
        if a.profile_step_start is None or not is_primary():
            return
        if global_step == a.profile_step_start and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if self.device.type == "cuda" else [])
            self._profiler = profile(activities=acts)
            self._profiler.__enter__()
        stop = a.profile_step_stop if a.profile_step_stop is not None else a.profile_step_start + 3
        if global_step == stop:
            self._stop_profile()

    def _stop_profile(self):
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.__exit__(None, None, None)
        out = os.path.join(self.args.output_dir, "profile")
        os.makedirs(out, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(out, f"trace-{os.getpid()}.json"))
        self._profiler = None

    # -- logging ------------------------------------------------------------
    def _flush_step_log(self, pending: Dict):
        """Read and log the step metrics recorded a logging window ago."""
        m = pending["metrics"]
        self.log({"epoch": pending["epoch"], "step": pending["step"],
                  "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})

    def _open_logging(self):
        a = self.args
        if not is_primary() or self._log_file is not None or self._wandb is not None:
            return
        if a.report_to == "wandb":
            try:
                import wandb
            except ImportError:  # as the JAX Trainer: JSONL in its place
                wandb = None
            if wandb is not None:
                self._wandb = wandb
                if wandb.run is None:
                    wandb.init(name=a.run_name, config=dataclasses.asdict(a))
                return
        if a.report_to in ("jsonl", "wandb"):
            self._log_file = open(os.path.join(a.output_dir, "logs.jsonl"), "a")

    def log(self, metrics: Dict):
        if not is_primary():
            return
        if self._wandb is not None:
            self._wandb.log(metrics)
        if self._log_file is not None:
            self._log_file.write(json.dumps(metrics) + "\n")
            self._log_file.flush()

    def close(self):
        """Close the log file."""
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None
