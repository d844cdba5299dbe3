"""Training and fine-tuning command line, ``python -m poseidon_tpu_torch.train``:
``poseidon_tpu/train.py`` on the port's Trainer.

A JSON or YAML config (or a JSON string with ``--json_config``) with the
reference's keys (dataset, num_trajectories, model_name or the architecture
keys, lr, lr_embedding_recovery, lr_time_embedding, weight_decay,
lr_scheduler, warmup_ratio, early_stopping_patience, num_epochs, batch_size,
max_grad_norm; and attention_impl, score_dtype, compute_dtype, save_steps,
gradient_checkpointing); MODEL_MAP sizes; the model config derived from the
dataset's shape; fine-tuning from a reference-format checkpoint with the
embedding and recovery replaced where the channels differ; the
post-training test protocol (direct and AR, in and out of distribution).

Usage:
    python -m poseidon_tpu_torch.train --config run.json \\
        --data_path /data --checkpoint_path /ckpts [--device cpu]
    torchrun --nproc_per_node N -m poseidon_tpu_torch.train --config run.json \\
        --data_path /data --checkpoint_path /ckpts

The run directory is ``<checkpoint_path>/<project>/[<sweep>/]<run>``. It
trains on one device (``--device``, default ``cuda``; raises without a
card), or under ``torchrun`` on one card per process (NCCL; gloo with
``--device cpu``): a (data, model) mesh of ``world / num_model_shards`` x
``num_model_shards`` (the config's ``num_model_shards``, default 1: data
parallel), as the JAX package's mesh. ``batch_size`` is per device, as in
the reference: the global batch is ``batch_size * world /
num_model_shards``. Process 0 writes the run directory and the log. W&B is
used only when ``--wandb_run_name`` or ``WANDB_SWEEP_ID`` is given and
``wandb`` can start a run; otherwise the log is ``logs.jsonl`` in the run
directory.
"""

from __future__ import annotations

import argparse
import json
import os
import re

# As the reference: no HDF5 file locking between loader threads.
os.environ.setdefault("HDF5_USE_FILE_LOCKING", "FALSE")

import numpy as np
import torch

from .config import MODEL_MAP, ScOTConfig
from .data.base import BaseTimeDataset, ConcatDataset
from .data.registry import get_dataset
from .metrics import ChannelGroupMetrics
from .models.scot import ScOT, build_model
from .parallel.host import broadcast_object, initialize_distributed, is_primary, process_count
from .training import Trainer, TrainingArguments
from .utils.params import get_num_parameters, get_num_parameters_no_embed

SEED = 0
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def read_cli(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags shared with the reference's CLI."""
    parser.add_argument("--config", type=str, required=True,
                        help="Path to YAML/JSON config file or a JSON string")
    parser.add_argument("--json_config", action="store_true",
                        help="Whether --config is a JSON string")
    parser.add_argument("--wandb_run_name", type=str, default=None)
    parser.add_argument("--wandb_project_name", type=str, default="scOT")
    parser.add_argument("--max_num_train_time_steps", type=int, default=None)
    parser.add_argument("--train_time_step_size", type=int, default=None)
    parser.add_argument("--train_small_time_transition", action="store_true",
                        help="Train only next-step transitions")
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("--disable_tqdm", action="store_true")
    parser.add_argument("--push_to_hf_hub", type=str, default=None)
    parser.add_argument("--just_velocities", action="store_true")
    parser.add_argument("--move_data", type=str, default=None)
    return parser


_SCI_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _coerce_sci(v):
    """YAML 1.1 (pyyaml) reads ``1e-6`` (no decimal point) as a string:
    such strings become floats."""
    if isinstance(v, str) and _SCI_FLOAT.match(v):
        return float(v)
    return v


def load_config(params) -> dict:
    """The run config: a JSON string, a ``.json`` file, or YAML (``yaml``
    imported only then). W&B's ``{key: {"value": v}}`` nesting is undone."""
    if params.json_config:
        return json.loads(params.config)
    with open(params.config) as f:
        if params.config.endswith(".json"):
            raw = json.load(f)
        else:
            import yaml

            raw = yaml.safe_load(f)
    return {k: _coerce_sci(v["value"] if isinstance(v, dict) and set(v) == {"value"} else v)
            for k, v in raw.items()}


def build_model_config(config: dict, dataset, time_involved: bool) -> ScOTConfig:
    """The model config from the run config and the dataset's shape."""
    return ScOTConfig(
        image_size=dataset.resolution,
        patch_size=config["patch_size"],
        num_channels=dataset.input_dim,
        num_out_channels=dataset.output_dim,
        embed_dim=config["embed_dim"],
        depths=tuple(config["depths"]),
        num_heads=tuple(config["num_heads"]),
        skip_connections=tuple(config["skip_connections"]),
        window_size=config["window_size"],
        mlp_ratio=config["mlp_ratio"],
        qkv_bias=True,
        hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
        drop_path_rate=0.0,
        hidden_act="gelu",
        use_absolute_embeddings=False,
        initializer_range=0.02,
        layer_norm_eps=1e-5,
        p=1,
        channel_slice_list_normalized_loss=tuple(dataset.channel_slice_list),
        residual_model="convnext",
        use_conditioning=time_involved,
        learn_residual=False,
        # Execution choices, settable from the run config ("pallas": the
        # port's kernels).
        attention_impl=config.get("attention_impl", "xla"),
        score_dtype=config.get("score_dtype", "float32"),
        scan_blocks=bool(config.get("scan_blocks", False)),
    )


def setup_datasets(config: dict, params):
    """Train and val sets with the CLI's time-restriction flags."""
    kwargs = {}
    if params.just_velocities and "incompressible" in str(config["dataset"]):
        kwargs["just_velocities"] = True
    if params.move_data is not None:
        kwargs["move_to_local_scratch"] = params.move_data
    if params.max_num_train_time_steps is not None:
        kwargs["max_num_time_steps"] = params.max_num_train_time_steps
    if params.train_time_step_size is not None:
        kwargs["time_step_size"] = params.train_time_step_size
    if params.train_small_time_transition:
        kwargs["allowed_time_transitions"] = [1]
    train_ds = get_dataset(config["dataset"], which="train",
                           num_trajectories=config["num_trajectories"],
                           data_path=params.data_path, **kwargs)
    val_ds = get_dataset(config["dataset"], which="val",
                         num_trajectories=config["num_trajectories"],
                         data_path=params.data_path, **kwargs)
    return train_ds, val_ds


def is_time_involved(dataset) -> bool:
    return isinstance(dataset, BaseTimeDataset) or (
        isinstance(dataset, ConcatDataset) and isinstance(dataset.datasets[0], BaseTimeDataset))


def wandb_setup(params, config: dict):
    """``(run, sweep_id, run_name)``. A W&B run is started on the primary
    process only when a run name or ``WANDB_SWEEP_ID`` is given, and
    without one (no ``wandb``, offline, no credentials) the sweep id comes
    from ``WANDB_SWEEP_ID`` and the run name from ``--wandb_run_name`` or a
    timestamp."""
    import time as _time

    run = None
    sweep_id = os.environ.get("WANDB_SWEEP_ID") or None
    if is_primary() and (params.wandb_run_name is not None or sweep_id):
        try:
            import wandb

            run = wandb.init(project=params.wandb_project_name,
                             name=params.wandb_run_name, config=config)
        except Exception as e:
            print(f"wandb.init failed ({e}); continuing with jsonl logging")
    if run is not None:
        if getattr(run, "sweep_id", None):
            sweep_id = run.sweep_id
        run_name = run.name or params.wandb_run_name
    else:
        run_name = params.wandb_run_name
    run_name = run_name or _time.strftime("run-%Y%m%d-%H%M%S")
    return run, sweep_id, run_name


def _check_channels(model_config: ScOTConfig, dataset) -> None:
    if (model_config.num_channels, model_config.num_out_channels) != (
            dataset.input_dim, dataset.output_dim):
        raise ValueError(
            f"the checkpoint's model takes {model_config.num_channels} channels in and "
            f"{model_config.num_out_channels} out; the dataset has {dataset.input_dim} and "
            f"{dataset.output_dim}: pass --replace_embedding_recovery to fine-tune onto it")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train (or fine-tune) scOT.")
    parser = read_cli(parser)
    parser.add_argument("--finetune_from", type=str, default=None,
                        help="Path to a pretrained checkpoint directory (reference layout)")
    parser.add_argument("--replace_embedding_recovery", action="store_true",
                        help="Replace embeddings/recovery when channels differ")
    parser.add_argument("--resume_training", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    params = parser.parse_args(argv)
    device = initialize_distributed(params.device)

    np.random.seed(SEED)
    config = load_config(params)
    run, sweep_id, run_name = wandb_setup(params, config)
    if "model_name" in config:
        # An unknown name fails: skipping the merge would train whatever
        # sizes the config happens to carry.
        if config["model_name"] not in MODEL_MAP:
            raise KeyError(f"unknown model_name {config['model_name']!r}; "
                           f"expected one of {sorted(MODEL_MAP)}")
        config = {**config, **MODEL_MAP[config["model_name"]]}
        if run is not None:
            run.config.update(MODEL_MAP[config["model_name"]], allow_val_change=True)

    # <ckpt>/<project>/[<sweep_id>/]<run>: the sweep level is what the
    # inference CLI's sweep modes walk.
    parts = [params.checkpoint_path, params.wandb_project_name]
    if sweep_id:
        parts.append(sweep_id)
    parts.append(run_name)
    ckpt_dir = broadcast_object(os.path.join(*parts))
    os.makedirs(ckpt_dir, exist_ok=True)

    train_ds, val_ds = setup_datasets(config, params)
    time_involved = is_time_involved(train_ds)

    if params.finetune_from is not None and not params.replace_embedding_recovery:
        # Without --replace_embedding_recovery the checkpoint's own config
        # is used as it is (the reference passes config=None): a channel
        # mismatch with the dataset fails; only the execution choices come
        # from the run config.
        from .hub import load_config as load_ckpt_config
        from .hub import resolve_model_path

        ckpt_cfg = load_ckpt_config(resolve_model_path(params.finetune_from))
        model_config = ckpt_cfg.replace(
            attention_impl=config.get("attention_impl", ckpt_cfg.attention_impl),
            score_dtype=config.get("score_dtype", ckpt_cfg.score_dtype),
            scan_blocks=bool(config.get("scan_blocks", ckpt_cfg.scan_blocks)))
        _check_channels(model_config, train_ds)
    else:
        model_config = build_model_config(config, train_ds, time_involved)

    # batch_size is per device, as in the reference (train.py:280 passes it
    # to per_device_train_batch_size under accelerate); the Trainer takes the
    # global batch: the ranks of one model group share their rows.
    num_model_shards = int(config.get("num_model_shards", 1))
    dp_size = max(process_count() // num_model_shards, 1)
    global_batch = int(config["batch_size"]) * dp_size
    finetune = params.finetune_from is not None

    args = TrainingArguments(
        output_dir=ckpt_dir,
        train_batch_size=global_batch,
        eval_batch_size=global_batch,
        num_model_shards=num_model_shards,
        gradient_checkpointing=bool(config.get("gradient_checkpointing", False)),
        num_train_epochs=config["num_epochs"],
        learning_rate=config["lr"],
        learning_rate_embedding_recovery=(
            config["lr_embedding_recovery"]
            if finetune and "lr_embedding_recovery" in config else None),
        learning_rate_time_embedding=(
            config["lr_time_embedding"] if finetune and "lr_time_embedding" in config else None),
        weight_decay=config["weight_decay"],
        lr_scheduler_type=config.get("lr_scheduler", "cosine"),
        warmup_ratio=config.get("warmup_ratio", 0.0),
        max_grad_norm=config.get("max_grad_norm", 1.0),
        compute_dtype=config.get("compute_dtype", "bfloat16"),
        save_steps=config.get("save_steps"),
        early_stopping_patience=config.get("early_stopping_patience"),
        seed=SEED,
        report_to="wandb" if run is not None else "jsonl",
        run_name=run_name,
        resume_from_checkpoint=params.resume_training,
    )
    dtype = DTYPES[args.compute_dtype]
    remat = args.gradient_checkpointing

    if finetune:
        from .hub import from_pretrained

        # ignore_mismatched_sizes only with --replace_embedding_recovery:
        # without it the model has the checkpoint's own config, and any
        # mismatch is an error.
        model, info = from_pretrained(
            params.finetune_from, config=model_config,
            ignore_mismatched_sizes=params.replace_embedding_recovery, device=device,
            dtype=dtype, output_loading_info=True)
        model.remat = remat
        if is_primary() and info["replaced"]:
            print(f"Re-initialized {len(info['replaced'])} mismatched tensors "
                  f"(embedding/recovery replacement): {', '.join(info['replaced'])}")
    else:
        model = build_model(model_config, device=device, dtype=dtype, seed=SEED, remat=remat)

    metrics_fn = ChannelGroupMetrics(list(train_ds.channel_slice_list),
                                     list(train_ds.printable_channel_description))
    trainer = Trainer(model, args, train_dataset=train_ds, eval_dataset=val_ds,
                      compute_metrics=metrics_fn, device=device)
    if is_primary():
        print(f"Model size: {get_num_parameters(model)}")
        print(f"Model size without embeddings: {get_num_parameters_no_embed(model)}")

    trainer.train(resume_from_checkpoint=params.resume_training)
    trainer.save_model(ckpt_dir)

    # Under FSDP the whole weights are gathered (every rank takes part).
    export_sd = trainer.model_state_dict() if params.push_to_hf_hub is not None else None
    if params.push_to_hf_hub is not None and is_primary():
        # A reference-format export, uploaded when the Hub can be reached
        # (the export stays either way).
        from .hub import push_to_hub, save_pretrained

        export_dir = os.path.join(ckpt_dir, "hub_export")
        export = trainer.model
        if trainer.sharded:
            export = ScOT(trainer.config)
            export.load_state_dict(export_sd)
        save_pretrained(export, export_dir)
        print(f"Exported Hub-compatible checkpoint to {export_dir}")
        if push_to_hub(params.push_to_hf_hub, export_dir):
            print(f"Pushed to HF Hub repo {params.push_to_hf_hub}")

    # ----- post-training test protocol --------------------------------------
    do_test = (params.max_num_train_time_steps is None
               and params.train_time_step_size is None
               and not params.train_small_time_transition
               and ".time" not in str(config["dataset"]))
    if not do_test:
        trainer.close()
        return trainer

    test_kwargs = {}
    if params.just_velocities and "incompressible" in str(config["dataset"]):
        test_kwargs["just_velocities"] = True
    if params.move_data is not None:
        test_kwargs["move_to_local_scratch"] = params.move_data
    out_kwargs = dict(test_kwargs)
    if time_involved:
        test_kwargs.update(max_num_time_steps=1, time_step_size=14,
                           allowed_time_transitions=[1])
        out_kwargs.update(max_num_time_steps=1, time_step_size=20,
                          allowed_time_transitions=[1])
    if "RayleighTaylor" in str(config["dataset"]):
        test_kwargs.update(max_num_time_steps=1, time_step_size=7,
                           allowed_time_transitions=[1])
        out_kwargs.update(max_num_time_steps=1, time_step_size=10,
                          allowed_time_transitions=[1])

    test_ds = get_dataset(config["dataset"], which="test",
                          num_trajectories=config["num_trajectories"],
                          data_path=params.data_path, **test_kwargs)
    try:
        out_ds = get_dataset(str(config["dataset"]) + ".out", which="test",
                             num_trajectories=config["num_trajectories"],
                             data_path=params.data_path, **out_kwargs)
    except Exception:
        out_ds = None

    def _plot(pred, prefix):
        # Prediction grids, only into a W&B run (and a PNG beside the
        # checkpoints); a failed plot never stops the protocol.
        if run is None or not is_primary() or pred.predictions.shape[0] < 4:
            return
        try:
            from .utils.plotting import create_predictions_plot

            fname = prefix.strip("/").replace("/", "_") + "_predictions.png"
            create_predictions_plot(pred.predictions, pred.label_ids,
                                    out_path=os.path.join(ckpt_dir, fname),
                                    wandb_prefix=prefix.strip("/"), seed=SEED)
        except Exception as e:
            print(f"prediction plot failed for {prefix}: {e}")

    results = {}
    pred = trainer.predict(test_ds, metric_key_prefix="test/")
    results.update(pred.metrics)
    _plot(pred, "test")
    if out_ds is not None:
        pred = trainer.predict(out_ds, metric_key_prefix="test_out_dist/")
        results.update(pred.metrics)
        _plot(pred, "test_out_dist")
    if time_involved and test_kwargs["time_step_size"] // 2 > 0:
        trainer.set_ar_steps(test_kwargs["time_step_size"] // 2)
        pred = trainer.predict(test_ds, metric_key_prefix="test/ar/")
        results.update(pred.metrics)
        _plot(pred, "test/ar")
        if out_ds is not None:
            trainer.set_ar_steps(out_kwargs["time_step_size"] // 2)
            pred = trainer.predict(out_ds, metric_key_prefix="test_out_dist/ar/")
            results.update(pred.metrics)
            _plot(pred, "test_out_dist/ar")
        trainer.set_ar_steps(None)

    if is_primary():
        trainer.log(results)
        print(json.dumps(results, indent=2, default=float))
    trainer.close()
    return trainer


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
