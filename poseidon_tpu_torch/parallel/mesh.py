"""The (data, model) device mesh and its sharding rules:
``poseidon_tpu/parallel/mesh.py`` on ``torch.distributed``.

The JAX package runs one SPMD program over a 2-D ``(data, model)`` mesh:
the batch is split over ``data``, and parameters and optimizer state are
sharded over ``model`` (each tensor of 2^16 elements or more on its
largest divisible axis). The port runs one process per card and gives the
same computation at the same global batch:

- ``model == 1``: ``DistributedDataParallel`` over the data axis; each
  rank holds every parameter and its rows of each batch.
- ``model > 1``: FSDP2 ``fully_shard`` over the 2-D mesh, which is HSDP:
  replicated over ``data``, sharded over ``model``. FSDP2 shards every
  parameter on its first axis, not on the axis :func:`param_partition_spec`
  picks; :func:`assert_opt_state_sharded` checks that every AdamW moment
  the JAX rule would shard is sharded over ``model``. The ranks of one
  model group see the same rows, as the devices of one model group do
  under ``P("data")``.

The JAX package's attention-mesh context (``set_attention_mesh``,
``attention_mesh_scope``, ``maybe_shard_map_data``) has no counterpart:
there, ``shard_map`` splits the Pallas attention over the data axis and
psums the cotangents of the replicated bias table and logit scales. Here
each rank launches its kernels on its own whole images, and those
cotangents are parameter gradients, which DDP and FSDP reduce.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, TypeVar

import numpy as np
import torch
import torch.distributed as dist

from .host import process_count

Batch = TypeVar("Batch", bound=Mapping)


def make_mesh(num_data: Optional[int] = None, num_model: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` of the process group's ranks, shape ``(num_data,
    num_model)``, dims named ``("data", "model")``; ``num_data`` defaults to
    the world size over ``num_model``. Rank r is data index ``r //
    num_model`` and model index ``r % num_model``, so the ranks of a model
    group are neighbours. Raises as the JAX function does when
    ``num_data * num_model`` is not the world size. The process group must
    be started (:func:`~poseidon_tpu_torch.parallel.host.initialize_distributed`)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = process_count()
    if num_data is None:
        num_data = world // num_model
    if num_data * num_model != world:
        raise ValueError(f"mesh {num_data}x{num_model} != {world} devices")
    ranks = torch.arange(world).reshape(num_data, num_model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def param_partition_spec(shape: Sequence[int], num_model: int,
                         min_size: int = 2**16) -> Tuple[Optional[str], ...]:
    """The JAX package's FSDP rule for one tensor of ``shape`` on a model
    axis of ``num_model``: ``"model"`` on the largest axis divisible by it
    (the last of equal ones), ``None`` elsewhere; ``()`` (replicated) for
    tensors under ``min_size`` elements or with no divisible axis."""
    shape = tuple(shape)
    if num_model <= 1 or int(np.prod(shape)) < min_size:
        return ()
    candidates = sorted(range(len(shape)), key=lambda i: (shape[i] % num_model == 0, shape[i]))
    best = candidates[-1]
    if shape[best] % num_model != 0:
        return ()
    spec = [None] * len(shape)
    spec[best] = "model"
    return tuple(spec)


def assert_opt_state_sharded(optimizer: torch.optim.Optimizer, mesh,
                             min_size: int = 2**16) -> int:
    """Check that every AdamW moment whose parameter the JAX rule
    (:func:`param_partition_spec`) would shard is a DTensor sharded over the
    mesh's ``"model"`` dim: replicated moments would hold the whole state on
    every card. Returns the number of moments checked (0 on a model axis of
    1); raises ``AssertionError`` naming the first few that are not."""
    from torch.distributed.tensor import DTensor

    num_model = mesh["model"].size()
    if num_model <= 1:
        return 0
    model_dim = mesh.mesh_dim_names.index("model")
    bad, checked = [], 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            if not param_partition_spec(p.shape, num_model, min_size):
                continue
            for key in ("exp_avg", "exp_avg_sq"):
                m = optimizer.state.get(p, {}).get(key)
                checked += 1
                if not (isinstance(m, DTensor) and m.placements[model_dim].is_shard()):
                    bad.append((key, tuple(p.shape)))
    if bad:
        raise AssertionError(
            f"{len(bad)} optimizer-state tensors are NOT sharded over the 'model' mesh axis "
            f"(replicated Adam moments hold the whole state on every card): "
            f"{bad[:5]}{'...' if len(bad) > 5 else ''}")
    return checked


def shard_batch(batch: Batch, mesh) -> Dict:
    """This rank's rows of a global host batch: rows ``[d * B / D, (d + 1) *
    B / D)`` of every entry for data index ``d`` of ``D`` (the rows the
    loader gives it, ``num_hosts=D``, ``host_id=d``). The ranks of one model
    group get the same rows."""
    size, index = mesh["data"].size(), mesh.get_local_rank("data")
    out = {}
    for k, v in batch.items():
        if v.shape[0] % size:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split over {size} data ranks")
        local = v.shape[0] // size
        out[k] = v[index * local:(index + 1) * local]
    return out


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The rows of ``x`` of every rank of ``group``, in rank order
    (``torch.cat`` of their ``x``). Gloo gathers on the CPU only, so under
    gloo the result is on the CPU."""
    if dist.get_backend(group) == "gloo":
        x = x.cpu()
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return torch.cat(out)
