"""Process identity, cross-process barriers, object broadcast and the
process group's start: ``poseidon_tpu/parallel/host.py`` on
``torch.distributed``.

Every helper is a single-process no-op when ``torch.distributed`` is not
initialised, so the same code runs in the CPU tests, on one card and in a
process group. :func:`initialize_distributed` starts the group from the
environment ``torchrun`` sets; without that environment nothing is
started.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def sync_hosts(name: str = "sync") -> None:
    """Barrier across processes (no-op for one process). ``name`` labels the
    barrier, as the JAX helper's does; ``torch.distributed`` needs none."""
    del name
    if process_count() > 1:
        dist.barrier()


def broadcast_object(obj: Any) -> Any:
    """``obj`` as process 0 holds it, on every process (pickled by
    ``torch.distributed.broadcast_object_list``)."""
    if process_count() <= 1:
        return obj
    box = [obj if is_primary() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def initialize_distributed(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device this process runs on, with the process group started when
    the process was launched by ``torchrun`` (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` set): on CUDA (the
    default) ``cuda:<LOCAL_RANK>``, made the current device, over NCCL; on
    the CPU (``device="cpu"``) over gloo. Without that environment, or with
    a group already started, nothing is started. As
    :func:`~poseidon_tpu_torch.utils.device.resolve_device`, a CUDA request
    without a card raises; nothing falls back to the CPU."""
    dev = resolve_device(device)
    launched = all(k in os.environ for k in TORCHRUN_ENV)
    if dev.type == "cuda" and dev.index is None and launched:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if launched and not _initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    return dev
