"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the reference computes from the same weights and
inputs, and their judgement against the cell's limits.

Training (the first three steps of the object the window then drives),
each the worst over the steps:

- ``loss_gap`` (``first_loss_gap``: the first step's): a step's loss,
  |program - reference| / |reference|;
- ``grad_norm_gap``: a step's gradient norm before clipping, the same;
- ``first_grad_gap``: the first step's gradient as the optimizer got it
  (its first moment after one step over 1 - beta1), by leaf: |program's
  norm - reference's| / max(reference's norm of that leaf, of the median
  leaf), the worst leaf; ``first_grad_median_gap`` the median leaf's;
- ``change_gap``: each leaf's change after three steps, the same, over the
  leaves whose reference gradient at the first step is at least a
  thousandth of the median leaf's (the others move by round-off alone);
  ``change_median_gap`` the median leaf's.

Under data parallelism every rank's readings are compared with the
reference's steps on the global batch, and each number is the worst
rank's. A cell's limits file names the numbers it compares; ``PERF.md``
gives the readings each limit was set from and why the others are not
compared.

Rollout: ``state_gap``, every predicted state of a sample of the requests
the window finished, relative L2 of each trajectory's state at each step,
the worst.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

SMALL_LEAF = 1e-3


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _rel(a: float, b: float) -> float:
    return _finite(abs(a - b) / abs(b)) if b != 0 else (0.0 if a == 0 else math.inf)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> List[float]:
    """|program's norm - reference's| / max(reference's norm of the leaf,
    of the median leaf), by leaf."""
    names = [k for k in ref if keep is None or k in keep]
    floor = statistics.median(ref[k] for k in names)
    return [_finite(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor)) for k in names]


def kept_leaves(first_raw: Dict[str, float]) -> set:
    floor = SMALL_LEAF * statistics.median(first_raw.values())
    return {k for k, v in first_raw.items() if v >= floor}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``: the program's readings (``losses``, ``grad_norms``,
    ``first_grad``, ``change``); ``ref``: the reference's."""
    keep = kept_leaves(ref["first_grad_raw"])
    losses = [_rel(a, b) for a, b in zip(prog["losses"], ref["losses"], strict=True)]
    norms = [_rel(a, b) for a, b in zip(prog["grad_norms"], ref["grad_norms"], strict=True)]
    first = leaf_gaps(prog["first_grad"], ref["first_grad"])
    change = leaf_gaps(prog["change"], ref["change"], keep)
    return {"loss_gap": max(losses), "first_loss_gap": losses[0],
            "grad_norm_gap": max(norms), "first_grad_gap": max(first),
            "first_grad_median_gap": statistics.median(first),
            "change_gap": max(change), "change_median_gap": statistics.median(change)}


def worst(numbers: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst over the ranks' (``train_numbers`` of each)."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def worst_names(prog: dict, ref: dict) -> Dict[str, list]:
    """The three worst leaves of each by-leaf number, with their gaps."""
    keep = kept_leaves(ref["first_grad_raw"])
    out = {}
    for key, names in (("first_grad", list(ref["first_grad"])), ("change", sorted(keep))):
        floor = statistics.median(ref[key][k] for k in names)
        gaps = [(abs(prog[key].get(k, 0.0) - ref[key][k]) / max(ref[key][k], floor), k)
                for k in names]
        out[key] = [[k, g, ref[key][k]] for g, k in sorted(gaps, reverse=True)[:3]]
    return out


def state_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """(B, steps, C, H, W) each: the worst relative L2 of one trajectory's
    state at one step."""
    p, r = prog.float().flatten(2), ref.float().flatten(2)
    gap = (p - r).norm(dim=-1) / r.norm(dim=-1).clamp(min=1e-30)
    return _finite(float(gap.max())) if bool(torch.isfinite(gap).all()) else math.inf


def compared(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, float]:
    """The numbers the cell's limits name (a named number not computed
    reads as infinite)."""
    return {k: numbers.get(k, math.inf) for k in limits}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the limits name at or under its limit, and at least one."""
    return bool(limits) and all(v <= limits[k] for k, v in compared(numbers, limits).items())


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"{k} {v!r} limit {limits[k]!r}" for k, v in compared(numbers, limits).items()]
