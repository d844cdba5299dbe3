"""Weights and inputs from the seed: the benchmark's one generator.

Weights: one draw of N(0, 1) for every weight together, on the device,
scaled by ``init_std``, with the offsets of a trained network's operating
point added where a plain draw would leave a layer degenerate: 1 on the
conditional norms' scale bias (unit scale at lead time 0), log 10 on the
attention's logit scale (its initial value in the published model). The
same dict feeds the system under test (``load_state_dict``) and the
reference.

Inputs: a pool of batches, each drawn on the device from its own
generator, inputs and labels N(0, 1), one lead time for every row, and the
traffic's masked output channels. A run cycles through the pool. Under
data parallelism each rank draws its own shard of every global batch from
a generator of its own; the global batch is the shards in rank order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .reference.scot import is_norm_param, param_shapes

_MASK = (1 << 63) - 1


def subseed(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream ``keys`` of ``seed`` (any integer)."""
    s = seed & _MASK
    for k in keys:
        s = (s * 6364136223846793005 + 1442695040888963407 + k) & _MASK
    return s


def make_weights(model: dict, seed: int, device, init_std: float) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(model)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device).manual_seed(subseed(seed, 1))
    flat = torch.randn(sum(sizes), generator=gen, device=device).mul_(init_std)
    out = {}
    for (name, shape), part in zip(shapes, torch.split(flat, sizes)):
        w = part.view(shape)
        if name.endswith(".logit_scale"):
            w.add_(math.log(10.0))
        elif name.endswith(".weight.bias") and is_norm_param(name):
            w.add_(1.0)
        out[name] = w
    return out


def make_batch(model: dict, traffic: dict, seed: int, index: int, device,
               rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Batch ``index`` of the pool: ``traffic["batch"]`` rows; with
    ``rank``, that rank's shard of global batch ``index``."""
    n = traffic["batch"]
    size, cin, cout = model["image_size"], model["num_channels"], model["num_out_channels"]
    keys = (2, index) if rank is None else (2, index, rank)
    gen = torch.Generator(device).manual_seed(subseed(seed, *keys))
    x = torch.randn((n, cin, size, size), generator=gen, device=device)
    batch = {"pixel_values": x, "time": torch.full((n,), float(traffic["lead_time"]),
                                                    device=device)}
    if traffic["loop"] != "rollout":
        batch["labels"] = torch.randn((n, cout, size, size), generator=gen, device=device)
        mask = torch.zeros((n, cout), dtype=torch.bool, device=device)
        mask[:, traffic.get("masked_channels", [])] = True
        batch["pixel_mask"] = mask
    return batch


def global_batch(model: dict, traffic: dict, seed: int, index: int, device,
                 world: int) -> Dict[str, torch.Tensor]:
    """Global batch ``index``: batch ``index`` itself on one rank, else the
    ``world`` ranks' shards in rank order."""
    if world == 1:
        return make_batch(model, traffic, seed, index, device)
    shards = [make_batch(model, traffic, seed, index, device, r) for r in range(world)]
    return {k: torch.cat([s[k] for s in shards]) for k in shards[0]}


def make_pool(model: dict, traffic: dict, seed: int, device,
              rank: Optional[int] = None) -> List[Dict[str, torch.Tensor]]:
    return [make_batch(model, traffic, seed, i, device, rank) for i in range(traffic["pool"])]
