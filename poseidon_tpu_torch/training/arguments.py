"""Training arguments: ``poseidon_tpu.training.arguments.TrainingArguments``
field for field, so that a JAX run's arguments load."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..parallel.host import process_count


@dataclasses.dataclass
class TrainingArguments:
    output_dir: str = "./checkpoints"
    # GLOBAL batch sizes (summed over all devices/hosts).
    train_batch_size: int = 32
    eval_batch_size: int = 32
    num_train_epochs: int = 1
    learning_rate: float = 1e-4
    # Extra LR for embedding/patch-recovery params when finetuning with
    # replaced channels (reference trainer.py:236-249).
    learning_rate_embedding_recovery: Optional[float] = None
    # Extra LR for ConditionalLayerNorm (time-embedding) params.
    learning_rate_time_embedding: Optional[float] = None
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    lr_scheduler_type: str = "cosine"
    warmup_ratio: float = 0.0
    max_grad_norm: float = 1.0
    seed: int = 0
    logging_steps: int = 5
    # Evaluate/save every N epochs (1 = per-epoch like the reference; raise
    # for tiny epochs where checkpoint saves dominate wall time).
    eval_every_epochs: int = 1
    save_every_epochs: int = 1
    # Additionally checkpoint every N optimizer steps WITHIN an epoch
    # (step-granular resume — HF's resume_from_checkpoint restores mid-epoch
    # too, reference train.py:409 via the HF Trainer). None = epoch-boundary
    # checkpoints only. Resuming from a mid-epoch checkpoint reproduces the
    # uninterrupted run bit-for-bit (deterministic loader + per-step rng
    # folded from the global step).
    # DELIBERATE DEVIATION from HF semantics (as in the JAX package): the
    # cadence is keyed on the within-epoch batch index, not the global
    # optimizer step — after epoch 1 the two diverge unless
    # steps_per_epoch % save_steps == 0. Per-epoch keying keeps the
    # checkpoint name (checkpoint-E-stepN) aligned with the loader's
    # (epoch, start_batch) resume coordinates.
    save_steps: Optional[int] = None
    save_total_limit: int = 1
    load_best_model_at_end: bool = True
    metric_for_best_model: str = "loss"
    greater_is_better: bool = False
    early_stopping_patience: Optional[int] = None
    early_stopping_threshold: float = 0.0
    num_workers: int = 8
    # Compute dtype for matmuls/convs ("bfloat16" or "float32"); params and
    # optimizer state stay fp32. Read by whoever builds the model
    # (``build_model(..., dtype=...)``), not by the Trainer.
    compute_dtype: str = "bfloat16"
    # Parameter sharding over a model axis: the processes form a (data,
    # model) mesh of world / num_model_shards x num_model_shards (FSDP over
    # ``model``, replicated over ``data``); must divide the world size.
    num_model_shards: int = 1
    # Recompute each Swin block in the backward. As in the JAX package the
    # Trainer only carries the flag: whoever builds the model passes it as
    # ``remat`` (the train CLI does).
    gradient_checkpointing: bool = False
    report_to: str = "jsonl"  # "jsonl" | "wandb" | "none"
    run_name: Optional[str] = None
    resume_from_checkpoint: bool = False
    # Capture a torch.profiler trace of training steps [profile_start,
    # profile_stop) into <output_dir>/profile (a Chrome trace). None disables
    # profiling.
    profile_step_start: Optional[int] = None
    profile_step_stop: Optional[int] = None

    def __post_init__(self):
        world = process_count()
        if self.num_model_shards < 1 or world % self.num_model_shards:
            raise ValueError(f"num_model_shards={self.num_model_shards} does not divide the "
                             f"world size {world}")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', got "
                             f"{self.compute_dtype!r}")
