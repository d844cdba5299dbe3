"""All-to-all time-pair sampling for time-dependent PDE trajectories.

Pure-function mirror of the index math in the reference ``BaseTimeDataset``
(the reference scOT, problems/base.py:276-364): a trajectory with
``max_num_time_steps`` usable steps of stride ``time_step_size`` yields every
ordered pair (t1, t2) with t1 <= t2 on the subsampled grid, optionally filtered
to a set of allowed transitions (in units of raw steps). A dataset index is
decomposed as ``idx = trajectory * multiplier + pair_index``.

The port's copy of ``poseidon_tpu/data/time_sampling.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def build_time_indices(
    max_num_time_steps: int,
    time_step_size: int,
    allowed_time_transitions: Optional[Sequence[int]] = None,
) -> List[Tuple[int, int]]:
    """Enumerate (t1, t2) raw-step pairs, t1 <= t2, on the subsampled grid.

    ``allowed_time_transitions`` filters on (j - i), the transition measured in
    subsampled-grid units (reference base.py:343-354 — note the filter applies
    BEFORE multiplying by time_step_size).
    """
    pairs: List[Tuple[int, int]] = []
    for i in range(max_num_time_steps + 1):
        for j in range(i, max_num_time_steps + 1):
            if allowed_time_transitions is not None and (j - i) not in allowed_time_transitions:
                continue
            pairs.append((time_step_size * i, time_step_size * j))
    return pairs


def idx_map(
    idx: int,
    multiplier: int,
    time_indices: Optional[Sequence[Tuple[int, int]]],
    fix_input_to_time_step: Optional[int] = None,
    time_step_size: Optional[int] = None,
) -> Tuple[int, int, int, int]:
    """Decompose a flat dataset index into (trajectory, dt, t1, t2).

    Mirrors reference base.py:305-317. When ``fix_input_to_time_step`` is set
    (pinned-start evaluation), t1 is fixed and t2 walks forward in strides of
    ``time_step_size``.
    """
    traj = idx // multiplier
    sub = idx - traj * multiplier
    if fix_input_to_time_step is None:
        t1, t2 = time_indices[sub]
        assert t2 >= t1
    else:
        t1 = fix_input_to_time_step
        t2 = time_step_size * (sub + 1) + fix_input_to_time_step
    return traj, t2 - t1, t1, t2


def resolve_num_trajectories(num_trajectories: int, n_max: int, n_val: int, n_test: int) -> int:
    """Resolve the -1/-2/-8 sentinels to all/half/eighth of the available
    training trajectories (reference base.py:219-224)."""
    avail = n_max - n_val - n_test
    if num_trajectories == -1:
        return avail
    if num_trajectories == -2:
        return avail // 2
    if num_trajectories == -8:
        return avail // 8
    if num_trajectories <= 0:
        raise ValueError(f"num_trajectories must be positive or in (-1, -2, -8), got {num_trajectories}")
    return num_trajectories


def split_start(which: str, n_max: int, n_val: int, n_test: int) -> int:
    """First trajectory index of the requested split (reference base.py:228-236):
    train starts at 0, val at N_max - N_val - N_test, test at N_max - N_test."""
    if which == "train":
        return 0
    if which == "val":
        return n_max - n_val - n_test
    if which == "test":
        return n_max - n_test
    raise ValueError(f"which must be train/val/test, got {which!r}")
