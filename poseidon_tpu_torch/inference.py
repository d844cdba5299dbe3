"""Inference and evaluation command line, ``python -m
poseidon_tpu_torch.inference``: ``poseidon_tpu/inference.py`` flag for flag,
on the port's Trainer.

Modes:

- ``save_samples``: the first n (input, prediction, label) triples as .npy;
- ``save_samples_sweep``: the same for every run of a sweep;
- ``eval``: metrics on a test set (direct, or ``--ar_steps`` AR), one CSV row;
- ``eval_sweep``: ``eval`` for every run of a sweep;
- ``eval_accumulation_error``: the AR rollout's error at each step against
  the ground-truth trajectory;
- ``eval_resolutions``: ``eval`` at other input resolutions (the dataset
  downsamples spectrally, the model resamples back to its own size).

The model runs in fp32 compute on ``--device`` (default ``cuda``; raises
when CUDA is absent, so the CPU must be asked for). Its path is the one
its config selects: with ``attention_impl="pallas"`` the attention and MLP
kernels (fp32: the general kernels), otherwise the plain path. Sweeps are
listed offline from ``--run_names`` or the checkpoint directory; the W&B
API is asked only with ``--wandb_entity``. The JAX CLI's persistent
compilation cache has no counterpart: eager PyTorch compiles nothing.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
from typing import Optional

# As the reference: no HDF5 file locking between loader threads.
os.environ.setdefault("HDF5_USE_FILE_LOCKING", "FALSE")

import numpy as np
import torch

from .config import ScOTConfig
from .data.registry import get_dataset
from .metrics import ChannelGroupMetrics
from .models.scot import ScOT
from .training import Trainer, TrainingArguments
from .training.trainer import CHECKPOINT_FILE
from .utils.device import resolve_device

# ---------------------------------------------------------------------------
# Library helpers
# ---------------------------------------------------------------------------


def make_compute_metrics(channel_slice_list, printable_channel_description,
                         full_data: bool = False) -> ChannelGroupMetrics:
    """The relative and absolute L1 battery of the reference; ``full_data``
    adds the per-sample error lists. Streams in the Trainer
    (``per_sample`` / ``from_samples``)."""
    return ChannelGroupMetrics(channel_slice_list, printable_channel_description,
                               absolute=True, full_data=full_data)


def _read_config(*dirs: str) -> ScOTConfig:
    for d in dirs:
        path = os.path.join(d, "config.json")
        if os.path.isfile(path):
            with open(path) as f:
                return ScOTConfig.from_dict(json.load(f))
    raise FileNotFoundError(f"no config.json in {' or '.join(dirs)}")


def _model_from_state(cfg: ScOTConfig, sd, dtype: torch.dtype) -> ScOT:
    model = ScOT(cfg, dtype=dtype, use_mask_token="embeddings.mask_token" in sd)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def load_model(model_path: str, dtype: torch.dtype = torch.float32, device=None) -> ScOT:
    """The model saved at ``model_path``, in eval mode on ``device``:

    - the Trainer's final save (``model/state_dict.pt`` beside
      ``config.json``);
    - a Trainer checkpoint (``checkpoint-*`` or ``best``: ``state.pt``), its
      config from the directory or, as the Trainer writes it, the run
      directory above;
    - a reference-format directory (``hub.from_pretrained``)."""
    dev = resolve_device(device)
    final = os.path.join(model_path, "model", "state_dict.pt")
    if os.path.isfile(final):
        sd = torch.load(final, map_location="cpu", weights_only=True)
        return _model_from_state(_read_config(model_path), sd, dtype).to(dev)
    ckpt = os.path.join(model_path, CHECKPOINT_FILE)
    if os.path.isfile(ckpt):
        sd = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
        cfg = _read_config(model_path, os.path.dirname(os.path.abspath(model_path)))
        return _model_from_state(cfg, sd, dtype).to(dev)
    from .hub import from_pretrained

    return from_pretrained(model_path, device=dev, dtype=dtype)


def get_trainer(model_path: str, batch_size: int, dataset, full_data: bool = False,
                output_all_steps: bool = False, workers: int = 8, device=None) -> Trainer:
    """An inference-only Trainer (fp32) around the model at ``model_path``."""
    model = load_model(model_path, device=device)
    args = TrainingArguments(output_dir=model_path, train_batch_size=batch_size,
                             eval_batch_size=batch_size, num_workers=workers,
                             report_to="none", compute_dtype="float32")
    compute_metrics = make_compute_metrics(
        dataset.channel_slice_list, dataset.printable_channel_description, full_data)
    trainer = Trainer(model, args, eval_dataset=dataset, compute_metrics=compute_metrics,
                      device=next(model.parameters()).device)
    if output_all_steps:
        # Kept until the AR steps are set (by rollout()).
        trainer.set_ar_steps(None, output_all_steps=True)
    return trainer


def rollout(trainer: Trainer, dataset, ar_steps=1, output_all_steps=False):
    """AR prediction over a test set."""
    trainer.set_ar_steps(ar_steps, output_all_steps=output_all_steps)
    out = trainer.predict(dataset, metric_key_prefix="")
    trainer.set_ar_steps(None)
    return out


def get_test_set(dataset_name: str, data_path: str, initial_time: int, final_time: int,
                 num_trajectories: int = -1, **kwargs):
    """The test set from ``initial_time`` to ``final_time`` in one step."""
    return get_dataset(dataset_name, which="test", num_trajectories=num_trajectories,
                       data_path=data_path, fix_input_to_time_step=initial_time,
                       time_step_size=final_time - initial_time, max_num_time_steps=1,
                       **kwargs)


def get_first_n_inputs(dataset, n: int) -> np.ndarray:
    """The first n input fields of a dataset."""
    return np.stack([dataset[i]["pixel_values"] for i in range(n)])


def get_trajectories(dataset_name: str, data_path: str, initial_time: int, final_time: int,
                     time_step_size: int, num_trajectories: int = -1, **kwargs):
    """Ground-truth frames every ``time_step_size`` after ``initial_time``
    up to ``final_time``: (inputs (N, C, H, W), labels (N, steps, C_out, H,
    W))."""
    steps = list(range(initial_time + time_step_size, final_time + 1, time_step_size))
    sets = [get_test_set(dataset_name, data_path, initial_time, t2, num_trajectories, **kwargs)
            for t2 in steps]
    n = len(sets[0])
    inputs = np.stack([sets[0][i]["pixel_values"] for i in range(n)])
    labels = np.stack([np.stack([s[i]["labels"] for s in sets], axis=0) for i in range(n)])
    return inputs, labels


def append_csv(path: str, row: dict):
    """Append ``row`` to the CSV at ``path`` (header written with the first
    row)."""
    exists = os.path.exists(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(row.keys()))
        if not exists:
            writer.writeheader()
        writer.writerow(row)


# ---------------------------------------------------------------------------
# Modes
# ---------------------------------------------------------------------------

def _trainer(params, ds, **kw) -> Trainer:
    return get_trainer(params.model_path, params.batch_size, ds, device=params.device, **kw)


def mode_save_samples(params):
    ds = get_test_set(params.dataset, params.data_path, params.initial_time,
                      params.final_time, num_trajectories=-1)
    trainer = _trainer(params, ds)
    if params.ar_steps is not None:
        trainer.set_ar_steps(params.ar_steps)
    out = trainer.predict(ds)
    os.makedirs(params.file, exist_ok=True)
    n = min(params.num_samples, len(out.predictions))
    np.save(os.path.join(params.file, "inputs.npy"), get_first_n_inputs(ds, n))
    np.save(os.path.join(params.file, "predictions.npy"), out.predictions[:n])
    np.save(os.path.join(params.file, "labels.npy"), out.label_ids[:n])
    print(json.dumps(out.metrics, default=float))


def mode_eval(params):
    ds = get_test_set(params.dataset, params.data_path, params.initial_time,
                      params.final_time, num_trajectories=-1)
    trainer = _trainer(params, ds, full_data=getattr(params, "full_data", False))
    if params.ar_steps is not None:
        trainer.set_ar_steps(params.ar_steps)
    # Streamed: metrics only, the predictions never gathered on the host.
    out = trainer.predict(ds, return_predictions=False)
    row = {"model": params.model_path, "dataset": params.dataset,
           "initial_time": params.initial_time, "final_time": params.final_time,
           "ar_steps": params.ar_steps, **out.metrics}
    append_csv(params.file, row)
    print(json.dumps(out.metrics, default=float))


def mode_eval_accumulation_error(params):
    """The AR rollout's error at each step (every ``--time_step_size``,
    default 2) against the ground-truth trajectory."""
    dt = params.time_step_size or 2
    steps = list(range(params.initial_time + dt, params.final_time + 1, dt))
    ds = get_test_set(params.dataset, params.data_path, params.initial_time,
                      params.final_time, num_trajectories=-1)
    trainer = _trainer(params, ds)
    trainer.set_ar_steps([(t - params.initial_time) / (params.final_time - params.initial_time)
                          for t in steps], output_all_steps=True)
    preds, _, _ = trainer._predict_arrays(ds)  # (N, steps, C, H, W)
    _, traj = get_trajectories(params.dataset, params.data_path, params.initial_time,
                               params.final_time, dt, num_trajectories=-1)
    battery = make_compute_metrics(ds.channel_slice_list, ds.printable_channel_description,
                                   full_data=getattr(params, "full_data", False))
    rows = []
    for si, t2 in enumerate(steps):
        row = {"model": params.model_path, "dataset": params.dataset,
               "initial_time": params.initial_time, "final_time": t2,
               **battery(preds[:, si], traj[:, si])}
        rows.append(row)
        append_csv(params.file, row)
    print(json.dumps(rows, default=float))


def mode_eval_resolutions(params):
    """``eval`` at each of ``--resolutions``."""
    results = []
    for res in params.resolutions:
        kwargs = {} if res in (None, 128) else {"resolution": res}
        ds = get_test_set(params.dataset, params.data_path, params.initial_time,
                          params.final_time, num_trajectories=-1, **kwargs)
        trainer = _trainer(params, ds)
        if params.ar_steps is not None:
            trainer.set_ar_steps(params.ar_steps)
        out = trainer.predict(ds, return_predictions=False)
        row = {"model": params.model_path, "dataset": params.dataset, "resolution": res,
               **out.metrics}
        results.append(row)
        append_csv(params.file, row)
    print(json.dumps(results, default=float))


class _LocalRun:
    """A run found on disk, in place of a ``wandb.Api`` run."""

    def __init__(self, name, dataset):
        self.name = name
        self.config = {"dataset": dataset} if dataset else {}


def _sweep_runs(params):
    """The runs of a sweep: ``--run_names``, else every run directory under
    the sweep's checkpoint directory, unless ``--wandb_entity`` asks the
    W&B API (with its filters)."""
    if getattr(params, "run_names", None):
        return [_LocalRun(n, params.dataset) for n in params.run_names]
    if params.wandb_entity is None:
        sweep_dir = os.path.join(params.base_checkpoint_dir, params.wandb_project,
                                 params.sweep_id)
        names = sorted(os.listdir(sweep_dir)) if os.path.isdir(sweep_dir) else []
        return [_LocalRun(n, params.dataset) for n in names]
    import wandb

    sweep = wandb.Api().sweep(f"{params.wandb_entity}/{params.wandb_project}/{params.sweep_id}")
    runs = [r for r in sweep.runs if params.allow_failed or r.state == "finished"]
    if params.exclude_dataset:
        runs = [r for r in runs if r.config.get("dataset") not in params.exclude_dataset]
    if params.only_dataset:
        runs = [r for r in runs if r.config.get("dataset") in params.only_dataset]
    if params.filter_trajectories:
        runs = [r for r in runs
                if r.config.get("num_trajectories") in params.filter_trajectories]
    return runs


def _resolve_model_path(ckpt_dir: str) -> Optional[str]:
    """The loadable model in a run's directory: the directory itself when it
    holds the final save (``model/``), else ``best``, else the numerically
    highest ``checkpoint-N`` (``checkpoint-1000`` does not beat
    ``checkpoint-2000``), with a warning when there was a choice. None when
    the directory holds no candidate."""
    if os.path.isdir(os.path.join(ckpt_dir, "model")):
        return ckpt_dir
    dirs = [d for d in os.listdir(ckpt_dir)
            if os.path.isdir(os.path.join(ckpt_dir, d)) and d != "profile"]
    if not dirs:
        return None
    if "best" in dirs:
        pick = "best"
    else:
        def step(d):
            m = re.match(r"checkpoint-(\d+)$", d)
            return int(m.group(1)) if m else -1
        pick = max(sorted(dirs), key=step)
    if len(dirs) > 1:
        print(f"WARNING: more than one checkpoint in {ckpt_dir}; choosing {pick}")
    return os.path.join(ckpt_dir, pick)


def _sweep_iterate(params, fn):
    for run in _sweep_runs(params):
        ckpt_dir = os.path.join(params.base_checkpoint_dir, params.wandb_project,
                                params.sweep_id, run.name)
        if not os.path.isdir(ckpt_dir):
            print(f"skip {run.name}: no checkpoint at {ckpt_dir}")
            continue
        model_path = _resolve_model_path(ckpt_dir)
        if model_path is None:
            print(f"skip {run.name}: nothing loadable in {ckpt_dir}")
            continue
        sub = argparse.Namespace(**vars(params))
        sub.model_path = model_path
        sub.dataset = run.config.get("dataset") or params.dataset
        fn(sub)


MODES = {
    "save_samples": mode_save_samples,
    "save_samples_sweep": lambda p: _sweep_iterate(p, mode_save_samples),
    "eval": mode_eval,
    "eval_sweep": lambda p: _sweep_iterate(p, mode_eval),
    "eval_accumulation_error": mode_eval_accumulation_error,
    "eval_resolutions": mode_eval_resolutions,
}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Do different evaluations for a model, "
                                                 "see --mode.")
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--file", type=str, required=True,
                        help="Output CSV / sample directory")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--initial_time", type=int, default=0)
    parser.add_argument("--final_time", type=int, default=14)
    parser.add_argument("--time_step_size", type=int, default=None)
    parser.add_argument("--ar_steps", type=int, default=None)
    parser.add_argument("--mode", type=str, required=True, choices=list(MODES))
    parser.add_argument("--num_samples", type=int, default=4)
    parser.add_argument("--full_data", action="store_true",
                        help="Attach per-sample error lists to the output")
    parser.add_argument("--resolutions", type=int, nargs="+", default=[32, 64, 96, 128])
    parser.add_argument("--wandb_project", type=str, default=None)
    parser.add_argument("--wandb_entity", type=str, default=None)
    parser.add_argument("--sweep_id", type=str, default=None)
    parser.add_argument("--base_checkpoint_dir", type=str, default=None)
    parser.add_argument("--exclude_dataset", type=str, nargs="+", default=[])
    parser.add_argument("--only_dataset", type=str, nargs="+", default=[])
    parser.add_argument("--allow_failed", action="store_true")
    parser.add_argument("--filter_trajectories", type=int, nargs="+", default=[])
    parser.add_argument("--run_names", type=str, nargs="+", default=[],
                        help="Evaluate these sweep run names directly "
                             "(offline: skips the W&B API)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    params = parser.parse_args(argv)
    resolve_device(params.device)
    MODES[params.mode](params)


if __name__ == "__main__":
    main()
