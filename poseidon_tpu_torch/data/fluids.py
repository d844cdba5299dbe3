"""Fluid-dynamics datasets: incompressible Navier-Stokes (NS-*), forced NS
(FNS-KF), compressible Euler (CE-*), gravity (GCE-RT), and the steady airfoil
(SE-AF).

Schema/normalization parity with the reference scOT, problems/fluids/
{incompressible.py, compressible.py, normalization_constants.py} — HDF5 keys,
channel assembly order, z-normalization constants, pixel masks, and
N_max/N_val/N_test splits all match so models trained on either side see
identical tensors.

The port's copy of ``poseidon_tpu/data/fluids.py``; files open through
``base.open_data_file``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .base import BaseDataset, BaseTimeDataset, open_data_file

# Shared normalization constants for the NS/CE families (reference
# fluids/normalization_constants.py:3-9). Layout: (C, 1, 1) for broadcasting
# over (C, H, W).
NS_CE_CONSTANTS = {
    "mean": np.array([0.80, 0.0, 0.0, 0.0], np.float32).reshape(4, 1, 1),
    "std": np.array([0.31, 0.391, 0.356, 0.185], np.float32).reshape(4, 1, 1),
    "time": 20.0,
    "tracer_mean": 0.19586183,
    "tracer_std": 0.37,
}


def spectral_downsample(image: np.ndarray, target_size: int) -> np.ndarray:
    """FFT downsample of (C, H, W), matching the reference's dataset-side
    resampling (incompressible.py:75-83)."""
    n = image.shape[-2]
    freqs = np.fft.fftfreq(n, d=1.0 / n)
    sel = np.where((freqs >= -target_size / 2) & (freqs <= target_size / 2 - 1))[0]
    hat = np.fft.fft2(image, norm="forward")
    hat = hat[..., sel, :][..., :, sel]
    return np.fft.ifft2(hat, norm="forward").real.astype(np.float32)


class IncompressibleBase(BaseTimeDataset):
    """NS-* datasets: HDF5 ``velocity[traj, t, 0:2]``; constant density-1 and
    pressure-0 channels appended unless ``just_velocities``; optional tracer
    channel; optional transpose (ShearLayer); optional spectral downsample."""

    def __init__(self, n_max, file_path, *args, tracer=False,
                 just_velocities=False, transpose=False, resolution=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        assert self.max_num_time_steps * self.time_step_size <= 20

        self.N_max = n_max
        self.N_val = 120
        self.N_test = 240
        self.resolution = 128
        self.tracer = tracer
        self.just_velocities = just_velocities
        self.transpose = transpose

        path = self._move_to_local_scratch(self.data_path + file_path)
        self.reader = open_data_file(path)

        self.constants = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                          for k, v in NS_CE_CONSTANTS.items()}
        if just_velocities:
            self.constants["mean"] = self.constants["mean"][1:3]
            self.constants["std"] = self.constants["std"][1:3]

        self.input_dim = (4 if not tracer else 5) - (2 if just_velocities else 0)
        self.label_description = "[u,v]" if just_velocities else "[rho],[u,v],[p]"
        if tracer:
            self.label_description += ",[tracer]"

        mask = [False, False] if just_velocities else [False, False, False, True]
        if tracer:
            mask.append(False)
        self.pixel_mask = np.asarray(mask)

        if resolution is not None and resolution > 128:
            raise ValueError("Resolution must be <= 128")
        self.res = resolution

        self.post_init()

    def _velocity(self, traj: int, t: int) -> np.ndarray:
        v = np.asarray(self.reader["velocity"][traj, t, 0:2], np.float32)
        v = v.reshape(2, self.resolution, self.resolution)
        if self.transpose:
            v = np.swapaxes(v, -2, -1)
        return v

    def _assemble(self, vel: np.ndarray) -> np.ndarray:
        if self.just_velocities:
            out = vel
        else:
            one = np.ones((1, self.resolution, self.resolution), np.float32)
            zero = np.zeros((1, self.resolution, self.resolution), np.float32)
            out = np.concatenate([one, vel, zero], axis=0)
        return (out - self.constants["mean"]) / self.constants["std"]

    def __getitem__(self, idx):
        traj, t, t1, t2 = self._idx_map(idx)
        time = np.float32(t / self.constants["time"])
        i = traj + self.start

        inputs = self._assemble(self._velocity(i, t1))
        label = self._assemble(self._velocity(i, t2))

        if self.tracer:
            def tr(tt):
                x = np.asarray(self.reader["velocity"][i, tt, 2:3], np.float32)
                x = x.reshape(1, self.resolution, self.resolution)
                if self.transpose:
                    x = np.swapaxes(x, -2, -1)
                return (x - self.constants["tracer_mean"]) / self.constants["tracer_std"]
            inputs = np.concatenate([inputs, tr(t1)], axis=0)
            label = np.concatenate([label, tr(t2)], axis=0)

        if self.res is not None:
            inputs = spectral_downsample(inputs, self.res)
            label = spectral_downsample(label, self.res)

        return {"pixel_values": inputs, "labels": label, "time": time,
                "pixel_mask": self.pixel_mask}


class BrownianBridge(IncompressibleBase):
    def __init__(self, *args, tracer=False, just_velocities=False, **kwargs):
        if tracer:
            raise ValueError("BrownianBridge does not have a tracer")
        super().__init__(20000, "/NS-BB.nc", *args, tracer=False,
                         just_velocities=just_velocities, **kwargs)


class PiecewiseConstants(IncompressibleBase):
    def __init__(self, *args, tracer=False, just_velocities=False, **kwargs):
        super().__init__(20000, "/NS-PwC.nc", *args, tracer=tracer,
                         just_velocities=just_velocities, **kwargs)


class Gaussians(IncompressibleBase):
    def __init__(self, *args, tracer=False, just_velocities=False, **kwargs):
        if tracer:
            raise ValueError("Gaussians does not have a tracer")
        super().__init__(20000, "/NS-Gauss.nc", *args, tracer=False,
                         just_velocities=just_velocities, **kwargs)


class ShearLayer(IncompressibleBase):
    def __init__(self, *args, tracer=False, just_velocities=False, **kwargs):
        if tracer:
            raise ValueError("Shear layer does not have a tracer")
        super().__init__(40000, "/NS-SL.nc", *args, transpose=True, tracer=False,
                         just_velocities=just_velocities, **kwargs)


class VortexSheet(IncompressibleBase):
    def __init__(self, *args, tracer=False, just_velocities=False, **kwargs):
        if tracer:
            raise ValueError("VortexSheet does not have a tracer")
        super().__init__(20000, "/NS-SVS.nc", *args, tracer=False,
                         just_velocities=just_velocities, **kwargs)


class Sines(IncompressibleBase):
    def __init__(self, *args, tracer=False, just_velocities=False, **kwargs):
        if tracer:
            raise ValueError("Sines does not have a tracer")
        super().__init__(20000, "/NS-Sines.nc", *args, tracer=False,
                         just_velocities=just_velocities, **kwargs)


class KolmogorovFlow(BaseTimeDataset):
    """FNS-KF: forced NS with a static analytic sinusoidal forcing channel
    0.1*sin(2*pi*(x+y)), normalized and appended to inputs AND labels."""

    def __init__(self, *args, tracer=False, just_velocities=False, **kwargs):
        super().__init__(*args, **kwargs)
        assert self.max_num_time_steps * self.time_step_size <= 20
        assert tracer is False

        self.N_max = 20000
        self.N_val = 120
        self.N_test = 240
        self.resolution = 128
        self.just_velocities = just_velocities

        path = self._move_to_local_scratch(self.data_path + "/FNS-KF.nc")
        self.reader = open_data_file(path)

        self.constants = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                          for k, v in NS_CE_CONSTANTS.items()}
        # KF has its own velocity statistics (reference incompressible.py:167-170)
        self.constants["mean"][1] = -2.2424793e-13
        self.constants["mean"][2] = 4.1510376e-12
        self.constants["std"][1] = 0.22017328
        self.constants["std"][2] = 0.22078253
        if just_velocities:
            self.constants["mean"] = self.constants["mean"][1:3]
            self.constants["std"] = self.constants["std"][1:3]

        x = np.linspace(0, 1, self.resolution, dtype=np.float32)
        xx, yy = np.meshgrid(x, x, indexing="ij")
        forcing = (0.1 * np.sin(2.0 * np.pi * (xx + yy)))[None]
        self.constants["mean_forcing"] = -1.2996679288335145e-09
        self.constants["std_forcing"] = 0.0707106739282608
        self.forcing = ((forcing - self.constants["mean_forcing"])
                        / self.constants["std_forcing"]).astype(np.float32)

        self.input_dim = 5 - (2 if just_velocities else 0)
        self.label_description = ("[u,v],[g]" if just_velocities
                                  else "[rho],[u,v],[p],[g]")
        mask = ([False, False, False] if just_velocities
                else [False, False, False, True, False])
        self.pixel_mask = np.asarray(mask)

        self.post_init()

    def __getitem__(self, idx):
        traj, t, t1, t2 = self._idx_map(idx)
        time = np.float32(t / self.constants["time"])
        i = traj + self.start

        def frame(tt):
            v = np.asarray(self.reader["solution"][i, tt, 0:2], np.float32)
            v = v.reshape(2, self.resolution, self.resolution)
            if self.just_velocities:
                out = v
            else:
                one = np.ones((1, self.resolution, self.resolution), np.float32)
                zero = np.zeros((1, self.resolution, self.resolution), np.float32)
                out = np.concatenate([one, v, zero], axis=0)
            out = (out - self.constants["mean"]) / self.constants["std"]
            return np.concatenate([out, self.forcing], axis=0)

        return {"pixel_values": frame(t1), "labels": frame(t2), "time": time,
                "pixel_mask": self.pixel_mask}


# ---------------------------------------------------------------------------
# Compressible Euler
# ---------------------------------------------------------------------------

class CompressibleBase(BaseTimeDataset):
    """CE-* datasets: HDF5 ``data[traj, t, 0:4]`` = [rho, u, v, p]; per-dataset
    mean pressure subtracted before the shared z-normalization."""

    mean_pressure: float = 0.0

    def __init__(self, file_path, *args, tracer=False, **kwargs):
        super().__init__(*args, **kwargs)
        assert self.max_num_time_steps * self.time_step_size <= 20

        self.N_max = 10000
        self.N_val = 120
        self.N_test = 240
        self.resolution = 128
        self.tracer = tracer

        path = self._move_to_local_scratch(self.data_path + file_path)
        self.reader = open_data_file(path)
        self.constants = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                          for k, v in NS_CE_CONSTANTS.items()}

        self.input_dim = 4 if not tracer else 5
        self.label_description = ("[rho],[u,v],[p]" if not tracer
                                  else "[rho],[u,v],[p],[tracer]")
        self.pixel_mask = np.asarray([False] * self.input_dim)
        self.post_init()

    def _frame(self, traj, t):
        x = np.asarray(self.reader["data"][traj, t, 0:4], np.float32)
        x = x.reshape(4, self.resolution, self.resolution)
        x[3] -= self.mean_pressure
        return (x - self.constants["mean"]) / self.constants["std"]

    def __getitem__(self, idx):
        traj, t, t1, t2 = self._idx_map(idx)
        time = np.float32(t / self.constants["time"])
        i = traj + self.start
        inputs = self._frame(i, t1)
        label = self._frame(i, t2)
        if self.tracer:
            def tr(tt):
                x = np.asarray(self.reader["data"][i, tt, 4:5], np.float32)
                return x.reshape(1, self.resolution, self.resolution)
            inputs = np.concatenate([inputs, tr(t1)], axis=0)
            label = np.concatenate([label, tr(t2)], axis=0)
        return {"pixel_values": inputs, "labels": label, "time": time,
                "pixel_mask": self.pixel_mask}


class CompressibleGaussians(CompressibleBase):
    def __init__(self, *args, tracer=False, **kwargs):
        if tracer:
            raise NotImplementedError("Tracer not implemented for Gaussians")
        self.mean_pressure = 2.513
        super().__init__("/CE-Gauss.nc", *args, tracer=tracer, **kwargs)


class KelvinHelmholtz(CompressibleBase):
    def __init__(self, *args, tracer=False, **kwargs):
        if tracer:
            raise NotImplementedError("Tracer not implemented for KelvinHelmholtz")
        self.mean_pressure = 1.0
        super().__init__("/CE-KH.nc", *args, tracer=tracer, **kwargs)


class Riemann(CompressibleBase):
    def __init__(self, *args, tracer=False, **kwargs):
        if tracer:
            raise NotImplementedError("Tracer not implemented for Riemann")
        self.mean_pressure = 0.215
        super().__init__("/CE-RP.nc", *args, tracer=tracer, **kwargs)


class RiemannCurved(CompressibleBase):
    def __init__(self, *args, tracer=False, **kwargs):
        if tracer:
            raise NotImplementedError("Tracer not implemented for RiemannCurved")
        self.mean_pressure = 0.553
        super().__init__("/CE-CRP.nc", *args, tracer=tracer, **kwargs)


class RiemannKelvinHelmholtz(CompressibleBase):
    def __init__(self, *args, tracer=False, **kwargs):
        if tracer:
            raise NotImplementedError("Tracer not implemented for RiemannKelvinHelmholtz")
        self.mean_pressure = 1.33
        super().__init__("/CE-RPUI.nc", *args, tracer=tracer, **kwargs)


class RichtmyerMeshkov(BaseTimeDataset):
    """CE-RM with its own normalization constants and small split
    (reference compressible.py:56-111)."""

    def __init__(self, *args, tracer=False, **kwargs):
        super().__init__(*args, **kwargs)
        assert self.max_num_time_steps * self.time_step_size <= 20

        self.N_max = 1260
        self.N_val = 100
        self.N_test = 130
        self.resolution = 128

        path = self._move_to_local_scratch(self.data_path + "/CE-RM.nc")
        self.reader = open_data_file(path)

        self.constants = {
            "mean": np.array([1.1964245, -7.164812e-06, 2.8968952e-06, 1.5648036],
                             np.float32).reshape(4, 1, 1),
            "std": np.array([0.5543239, 0.24304213, 0.2430597, 0.89639103],
                            np.float32).reshape(4, 1, 1),
            "time": 20.0,
        }
        self.input_dim = 4
        self.label_description = "[rho],[u,v],[p]"
        self.pixel_mask = np.asarray([False] * 4)
        self.post_init()

    def __getitem__(self, idx):
        traj, t, t1, t2 = self._idx_map(idx)
        time = np.float32(t / self.constants["time"])
        i = traj + self.start

        def frame(tt):
            x = np.asarray(self.reader["solution"][i, tt, 0:4], np.float32)
            x = x.reshape(4, self.resolution, self.resolution)
            return (x - self.constants["mean"]) / self.constants["std"]

        return {"pixel_values": frame(t1), "labels": frame(t2), "time": time,
                "pixel_mask": self.pixel_mask}


class RayleighTaylor(BaseTimeDataset):
    """GCE-RT: 4 state channels + a gravitational-potential channel read from
    HDF5 index 5, normalized separately (reference compressible.py:113-188)."""

    def __init__(self, *args, tracer=False, **kwargs):
        super().__init__(*args, **kwargs)
        assert self.max_num_time_steps * self.time_step_size <= 10

        self.N_max = 1260
        self.N_val = 100
        self.N_test = 130
        self.resolution = 128

        path = self._move_to_local_scratch(self.data_path + "/GCE-RT.nc")
        self.reader = open_data_file(path)

        self.constants = {
            "mean": np.array([0.8970493, 4.0316996e-13, -1.3858967e-13,
                              0.7133829, -1.7055787], np.float32).reshape(5, 1, 1),
            "std": np.array([0.12857835, 0.014896976, 0.014896975,
                             0.21293919, 0.40131348], np.float32).reshape(5, 1, 1),
            "time": 10.0,
        }
        self.input_dim = 5
        self.label_description = "[rho],[u,v],[p],[g]"
        self.pixel_mask = np.asarray([False] * 5)
        self.post_init()

    def __getitem__(self, idx):
        traj, t, t1, t2 = self._idx_map(idx)
        time = np.float32(t / self.constants["time"])
        i = traj + self.start

        def frame(tt):
            x = np.asarray(self.reader["solution"][i, tt, 0:4], np.float32)
            x = x.reshape(4, self.resolution, self.resolution)
            g = np.asarray(self.reader["solution"][i, tt, 5:6], np.float32)
            g = g.reshape(1, self.resolution, self.resolution)
            x = (x - self.constants["mean"][:4]) / self.constants["std"][:4]
            g = (g - self.constants["mean"][4]) / self.constants["std"][4]
            return np.concatenate([x, g], axis=0)

        return {"pixel_values": frame(t1), "labels": frame(t2), "time": time,
                "pixel_mask": self.pixel_mask}


class Airfoil(BaseDataset):
    """SE-AF (steady): input is the unnormalized geometry/density field at
    time index 0; label the normalized density at index 1; per-sample pixel
    mask marks the airfoil body (inputs == 1), labels forced to 1 there
    (reference compressible.py:8-53)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.N_max = 10869
        self.N_val = 120
        self.N_test = 240
        self.resolution = 128

        path = self._move_to_local_scratch(self.data_path + "/SE-AF.nc")
        self.reader = open_data_file(path)
        self.constants = {"mean": 0.92984116, "std": 0.10864315}
        self.input_dim = 1
        self.label_description = "[rho]"
        self.post_init()

    def __getitem__(self, idx):
        i = idx + self.start
        inputs = np.asarray(self.reader["solution"][i, 0], np.float32)
        inputs = inputs.reshape(1, self.resolution, self.resolution)
        labels = np.asarray(self.reader["solution"][i, 1], np.float32)
        labels = labels.reshape(1, self.resolution, self.resolution)
        labels = (labels - self.constants["mean"]) / self.constants["std"]
        pixel_mask = inputs == 1
        labels = np.where(pixel_mask, np.float32(1.0), labels)
        return {"pixel_values": inputs, "labels": labels, "pixel_mask": pixel_mask}
