"""Elliptic (steady) datasets: Poisson-Gauss and Helmholtz.

Schema parity with the reference scOT, problems/elliptic/{poisson.py,
helmholtz.py}: Poisson maps a normalized source to a (separately normalized)
solution; Helmholtz reads per-sample HDF5 groups ``Sample_<i>/{a, bc, u}``,
inputs are (a - 1, constant-bc plane).

The port's copy of ``poseidon_tpu/data/elliptic.py``; files open through
``base.open_data_file``.
"""

from __future__ import annotations

import numpy as np

from .base import BaseDataset, open_data_file

POISSON_CONSTANTS = {
    "mean_source": 0.014822142414492256,
    "std_source": 4.755138816607612,
    "mean_solution": 0.0005603458434937093,
    "std_solution": 0.02401226126952699,
}


class PoissonGaussians(BaseDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.N_max = 20000
        self.N_val = 120
        self.N_test = 240
        self.resolution = 128

        path = self._move_to_local_scratch(self.data_path + "/Poisson-Gauss.nc")
        self.reader = open_data_file(path)
        self.constants = POISSON_CONSTANTS
        self.input_dim = 1
        self.label_description = "[u]"
        self.post_init()

    def __getitem__(self, idx):
        i = idx + self.start
        src = np.asarray(self.reader["source"][i], np.float32)
        src = src.reshape(1, self.resolution, self.resolution)
        sol = np.asarray(self.reader["solution"][i], np.float32)
        sol = sol.reshape(1, self.resolution, self.resolution)
        src = (src - self.constants["mean_source"]) / self.constants["std_source"]
        sol = (sol - self.constants["mean_solution"]) / self.constants["std_solution"]
        return {"pixel_values": src, "labels": sol}


class Helmholtz(BaseDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.N_max = 19675
        self.N_val = 128
        self.N_test = 512
        self.resolution = 128

        path = self._move_to_local_scratch(self.data_path + "/Helmholtz.h5")
        self.reader = open_data_file(path)
        self.mean = 0.11523915668552
        self.std = 0.8279975746000605
        self.input_dim = 2
        self.label_description = "[u]"
        self.post_init()

    def __getitem__(self, idx):
        grp = self.reader[f"Sample_{idx + self.start}"]
        a = np.asarray(grp["a"][:], np.float32)
        a = a.reshape(1, self.resolution, self.resolution) - 1.0
        bc = float(np.array(grp["bc"]))
        inputs = np.concatenate([a, np.full_like(a, bc)], axis=0)
        u = np.asarray(grp["u"][:], np.float32)
        u = u.reshape(1, self.resolution, self.resolution)
        u = (u - self.mean) / self.std
        return {"pixel_values": inputs, "labels": u}
