"""Process identity, cross-process barriers and object broadcast:
``poseidon_tpu/parallel/host.py`` on ``torch.distributed``.

Every helper is a single-process no-op when ``torch.distributed`` is not
initialised, so the same code runs in the CPU tests, on one card and in a
process group. The group is set up by its caller
(``torch.distributed.init_process_group``); this module starts nothing.
"""

from __future__ import annotations

from typing import Any

import torch.distributed as dist


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
