"""The PDE datasets, their registry and the host-side batch loader: the
JAX package's ``data/`` (numpy, and h5py for HDF5 files), kept as the port's
own copy."""

from .time_sampling import build_time_indices, idx_map, resolve_num_trajectories, split_start

__all__ = ["build_time_indices", "idx_map", "resolve_num_trajectories", "split_start"]
