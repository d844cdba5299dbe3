"""Allen-Cahn reaction-diffusion dataset (ACE).

Schema parity with the reference scOT, problems/reaction_diffusion/
allen_cahn.py: single channel, N_max 15000/60/240, time constant 19.

The port's copy of ``poseidon_tpu/data/reaction_diffusion.py``; files open through
``base.open_data_file``.
"""

from __future__ import annotations

import numpy as np

from .base import BaseTimeDataset, open_data_file


class AllenCahn(BaseTimeDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        assert self.max_num_time_steps * self.time_step_size <= 19

        self.N_max = 15000
        self.N_val = 60
        self.N_test = 240
        self.resolution = 128

        path = self._move_to_local_scratch(self.data_path + "/ACE.nc")
        self.reader = open_data_file(path)
        self.constants = {"mean": 0.002484262, "std": 0.65351176, "time": 19.0}
        self.input_dim = 1
        self.label_description = "[u]"
        self.post_init()

    def __getitem__(self, idx):
        traj, t, t1, t2 = self._idx_map(idx)
        time = np.float32(t / self.constants["time"])
        i = traj + self.start

        def u(tt):
            x = np.asarray(self.reader["solution"][i, tt], np.float32)
            x = x.reshape(1, self.resolution, self.resolution)
            return (x - self.constants["mean"]) / self.constants["std"]

        return {"pixel_values": u(t1), "labels": u(t2), "time": time}
