"""Acoustic wave-equation datasets (Wave-Layer / Wave-Gauss).

Schema parity with the reference scOT, problems/wave/acoustic.py: solution
``u(t)`` plus a static propagation-speed field ``c`` as channel 2; ``c`` is
copied into the labels as well.

The port's copy of ``poseidon_tpu/data/wave.py``; files open through
``base.open_data_file``.
"""

from __future__ import annotations

import numpy as np

from .base import BaseTimeDataset, open_data_file


class _WaveBase(BaseTimeDataset):
    file_name: str
    constants: dict
    max_total_time: int

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        assert self.max_num_time_steps * self.time_step_size <= self.max_total_time

        self.N_max = 10512
        self.N_val = 60
        self.N_test = 240
        self.resolution = 128

        path = self._move_to_local_scratch(self.data_path + "/" + self.file_name)
        self.reader = open_data_file(path)

        self.input_dim = 2
        self.label_description = "[u],[c]"
        self.post_init()

    def __getitem__(self, idx):
        traj, t, t1, t2 = self._idx_map(idx)
        time = np.float32(t / self.constants["time"])
        i = traj + self.start

        def u(tt):
            x = np.asarray(self.reader["solution"][i, tt], np.float32)
            x = x.reshape(1, self.resolution, self.resolution)
            return (x - self.constants["mean"]) / self.constants["std"]

        c = np.asarray(self.reader["c"][i], np.float32)
        c = c.reshape(1, self.resolution, self.resolution)
        c = (c - self.constants["mean_c"]) / self.constants["std_c"]

        return {
            "pixel_values": np.concatenate([u(t1), c], axis=0),
            "labels": np.concatenate([u(t2), c], axis=0),
            "time": time,
        }


class Layer(_WaveBase):
    file_name = "Wave-Layer.nc"
    max_total_time = 20
    constants = {
        "mean": 0.03467443221585092,
        "std": 0.10442421752963911,
        "mean_c": 3498.5644380917424,
        "std_c": 647.843958567462,
        "time": 20.0,
    }


class WaveGaussians(_WaveBase):
    file_name = "Wave-Gauss.nc"
    max_total_time = 15
    constants = {
        "mean": 0.0334376316,
        "std": 0.1171879068,
        "mean_c": 2618.4593933,
        "std_c": 601.51658913,
        "time": 15.0,
    }
