"""Dataset base classes for the PDE problem zoo: ``poseidon_tpu/data/base.py``
in the port (numpy, and h5py to read HDF5 files; the port keeps its own
copy so that it imports nothing of the JAX package).

Samples are dicts of numpy arrays
``{"pixel_values": (C, H, W) f32, "labels": (C_out, H, W) f32,
"time": f32 scalar, "pixel_mask": optional bool}`` — the exact sample schema
of the reference scOT (e.g. problems/fluids/incompressible.py:141-146), ready to be batched and fed to the device
pipeline.

Split/index semantics mirror the reference scOT, problems/base.py:164-395.
"""

from __future__ import annotations

import os
import re
import shutil
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Sequence, Tuple

# HDF5 locking hygiene (reference scOT/train.py:16, configs/sweep.yaml:9):
# our loader reads from a thread pool, and multi-process training may open the
# same file from several hosts; disable file locking before libhdf5 spins up.
os.environ.setdefault("HDF5_USE_FILE_LOCKING", "FALSE")

import numpy as np

from .time_sampling import (
    build_time_indices,
    idx_map,
    resolve_num_trajectories,
    split_start,
)


def open_data_file(path: str):
    """The reader of a dataset file, indexed as ``reader[key][...]``: an
    HDF5 file through h5py (imported here, so that the package imports
    without it), or a directory of ``<key>.npy`` arrays, one for each
    dataset of the HDF5 file, read as memory maps (for machines without
    h5py; files whose datasets sit in groups, as Helmholtz's, need HDF5)."""
    if os.path.isdir(path):
        return {name[:-4]: _NpyDataset(os.path.join(path, name))
                for name in sorted(os.listdir(path)) if name.endswith(".npy")}
    import h5py

    return h5py.File(path, "r")


class _NpyDataset:
    """A memory-mapped ``.npy`` array read as h5py reads a dataset: every
    read returns a new array."""

    def __init__(self, path: str):
        self._array = np.load(path, mmap_mode="r")
        self.shape, self.dtype = self._array.shape, self._array.dtype

    def __getitem__(self, index):
        return np.array(self._array[index])


def get_channel_lists(label_description: str) -> Tuple[List[str], List[int]]:
    """Parse a label description like "[rho],[u,v],[p]" into printable group
    names and cumulative channel boundaries (reference base.py:261-273)."""
    matches = re.findall(r"\[([^\[\]]+)\]", label_description)
    slices = [0]
    names = []
    for m in matches:
        slices.append(slices[-1] + 1 + m.count(","))
        parts = m.split(",")
        names.append("".join(parts) if len(parts) > 1 else m)
    return names, slices


class BaseDataset(ABC):
    """Steady (time-independent) problems.

    Subclasses must set ``N_max``, ``N_val``, ``N_test``, ``resolution``,
    ``input_dim``, ``label_description`` (and open their HDF5 reader) before
    calling :meth:`post_init`.
    """

    def __init__(
        self,
        which: str,
        num_trajectories: int,
        data_path: str = "./data",
        move_to_local_scratch: Optional[str] = None,
    ) -> None:
        if which not in ("train", "val", "test"):
            raise ValueError(f"which must be train/val/test, got {which!r}")
        self.which = which
        self.num_trajectories = num_trajectories
        self.data_path = data_path
        self.move_to_local_scratch = move_to_local_scratch

    # -- data staging -------------------------------------------------------
    def _move_to_local_scratch(self, file_path: str) -> str:
        """Optionally stage the data file to fast local scratch. In
        multi-process runs process 0 copies and everyone else waits on a
        barrier (replacing the reference's accelerate broadcast_object_list,
        base.py:192-208)."""
        if self.move_to_local_scratch is None:
            return file_path
        src = os.path.join(self.data_path, file_path) if not os.path.isabs(file_path) else file_path
        dest = os.path.join(self.move_to_local_scratch, os.path.basename(file_path))
        from ..parallel.host import process_index, sync_hosts

        if not os.path.exists(dest) and process_index() == 0:
            shutil.copy(src, dest)
        sync_hosts("scratch_staging:" + os.path.basename(file_path))
        return dest

    # -- split math ---------------------------------------------------------
    def post_init(self) -> None:
        assert self.N_max is not None and self.N_max > 0
        assert self.N_max >= self.N_val + self.N_test
        self.num_trajectories = resolve_num_trajectories(
            self.num_trajectories, self.N_max, self.N_val, self.N_test)
        assert self.num_trajectories + self.N_val + self.N_test <= self.N_max
        self.start = split_start(self.which, self.N_max, self.N_val, self.N_test)
        self.length = {
            "train": self.num_trajectories, "val": self.N_val, "test": self.N_test,
        }[self.which]
        self.output_dim = self.label_description.count(",") + 1
        names, slices = get_channel_lists(self.label_description)
        self.printable_channel_description = names
        self.channel_slice_list = slices

    def __len__(self) -> int:
        return self.length

    @abstractmethod
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ...


class BaseTimeDataset(BaseDataset, ABC):
    """Time-dependent problems with all-to-all (t1, t2) pair sampling."""

    def __init__(
        self,
        *args,
        max_num_time_steps: Optional[int] = None,
        time_step_size: Optional[int] = None,
        fix_input_to_time_step: Optional[int] = None,
        allowed_time_transitions: Optional[Sequence[int]] = None,
        **kwargs,
    ) -> None:
        assert max_num_time_steps is not None and max_num_time_steps > 0
        assert time_step_size is not None and time_step_size > 0
        assert fix_input_to_time_step is None or fix_input_to_time_step >= 0
        super().__init__(*args, **kwargs)
        self.max_num_time_steps = max_num_time_steps
        self.time_step_size = time_step_size
        self.fix_input_to_time_step = fix_input_to_time_step
        self.allowed_time_transitions = (
            list(allowed_time_transitions) if allowed_time_transitions is not None else None
        )

    def _idx_map(self, idx: int) -> Tuple[int, int, int, int]:
        return idx_map(
            idx, self.multiplier,
            getattr(self, "time_indices", None),
            self.fix_input_to_time_step, self.time_step_size,
        )

    def post_init(self) -> None:
        assert self.N_max is not None and self.N_max > 0
        assert self.N_max >= self.N_val + self.N_test
        self.num_trajectories = resolve_num_trajectories(
            self.num_trajectories, self.N_max, self.N_val, self.N_test)
        assert self.num_trajectories + self.N_val + self.N_test <= self.N_max

        if self.fix_input_to_time_step is not None:
            self.multiplier = self.max_num_time_steps
        else:
            self.time_indices = build_time_indices(
                self.max_num_time_steps, self.time_step_size,
                self.allowed_time_transitions)
            self.multiplier = len(self.time_indices)

        self.start = split_start(self.which, self.N_max, self.N_val, self.N_test)
        base_len = {
            "train": self.num_trajectories, "val": self.N_val, "test": self.N_test,
        }[self.which]
        self.length = base_len * self.multiplier

        self.output_dim = self.label_description.count(",") + 1
        names, slices = get_channel_lists(self.label_description)
        self.printable_channel_description = names
        self.channel_slice_list = slices


class TimeWrapper(BaseTimeDataset):
    """Present a steady dataset as time-dependent with constant time=1.0
    (reference base.py:372-395) — used to finetune time-conditioned models on
    ``.time`` datasets."""

    def __init__(self, dataset: BaseDataset):
        super().__init__(
            dataset.which, dataset.num_trajectories, dataset.data_path, None,
            max_num_time_steps=1, time_step_size=1,
        )
        self.dataset = dataset
        self.resolution = dataset.resolution
        self.input_dim = dataset.input_dim
        self.output_dim = dataset.output_dim
        self.channel_slice_list = dataset.channel_slice_list
        self.printable_channel_description = dataset.printable_channel_description

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        return {**self.dataset[idx], "time": np.float32(1.0)}


class ConcatDataset:
    """Concatenation of datasets for mixed-dataset pretraining (replacing
    torch.utils.data.ConcatDataset used at reference base.py:46-47)."""

    def __init__(self, datasets: Sequence):
        assert len(datasets) > 0
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.cum[-1])

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        ds_idx = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds_idx == 0 else int(self.cum[ds_idx - 1])
        return self.datasets[ds_idx][idx - prev]

    # Shape/metadata accessors read from the first member, mirroring
    # reference train.py:232-245.
    @property
    def resolution(self):
        return self.datasets[0].resolution

    @property
    def input_dim(self):
        return self.datasets[0].input_dim

    @property
    def output_dim(self):
        return self.datasets[0].output_dim

    @property
    def channel_slice_list(self):
        return self.datasets[0].channel_slice_list

    @property
    def printable_channel_description(self):
        return self.datasets[0].printable_channel_description
