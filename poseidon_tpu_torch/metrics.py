"""Lp / relative-Lp error metrics.

The port's copy of ``poseidon_tpu/metrics.py`` (numpy only), a behavioral
mirror of the reference scOT's metrics.py:4-55: errors are summed over pixels
AND over the channels present in the given slice, the relative variant
divides by the summed |target|^p with a 1e-10 zero-guard, takes the (1/p)-th
root and reports percent. Implemented for numpy arrays (metrics run on the
host after the Trainer copies predictions back); every function also accepts
CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def lp_error(preds, targets, p: int = 1) -> np.ndarray:
    """Absolute Lp error per sample, summed over channels and pixels.

    Args:
        preds, targets: arrays of shape (N, C, H, W) (or (N, C, ...)).
    Returns:
        (N,) array of per-sample errors.
    """
    preds = np.asarray(preds)
    targets = np.asarray(targets)
    n, c = preds.shape[0], preds.shape[1]
    err = np.abs(preds.reshape(n, c, -1) - targets.reshape(n, c, -1)) ** p
    return np.sum(err, axis=(1, 2)) ** (1.0 / p)


def relative_lp_error(preds, targets, p: int = 1, return_percent: bool = True) -> np.ndarray:
    """Relative Lp error per sample (percent by default)."""
    preds = np.asarray(preds)
    targets = np.asarray(targets)
    n, c = preds.shape[0], preds.shape[1]
    preds = preds.reshape(n, c, -1)
    targets = targets.reshape(n, c, -1)
    err = np.sum(np.abs(preds - targets) ** p, axis=(1, 2))
    norm = np.sum(np.abs(targets) ** p, axis=(1, 2))
    norm = np.where(norm == 0, 1e-10, norm)
    out = (err / norm) ** (1.0 / p)
    if return_percent:
        out = out * 100.0
    return out


def mean_relative_lp_error(preds, targets, p: int = 1, return_percent: bool = True):
    return np.mean(relative_lp_error(preds, targets, p, return_percent), axis=0)


def median_relative_lp_error(preds, targets, p: int = 1, return_percent: bool = True):
    return np.median(relative_lp_error(preds, targets, p, return_percent), axis=0)


def error_statistics(errors: np.ndarray, prefix: str = "relative_l1_error") -> Dict[str, float]:
    """Median/mean/std/min/max battery (reference train.py:347-359)."""
    return {
        f"median_{prefix}": float(np.median(errors, axis=0)),
        f"mean_{prefix}": float(np.mean(errors, axis=0)),
        f"std_{prefix}": float(np.std(errors, axis=0)),
        f"min_{prefix}": float(np.min(errors, axis=0)),
        f"max_{prefix}": float(np.max(errors, axis=0)),
    }


class ChannelGroupMetrics:
    """Per-channel-group metric battery with a STREAMING protocol.

    Callable form reproduces the reference batteries (train.py:344-398 for
    ``absolute=False``; inference.py:76-200 adds the absolute-L1 battery and
    optional per-sample ``full_data`` lists for ``absolute=True``).

    The streaming protocol bounds host memory for large eval sets (the
    reference bounds DEVICE memory with ``eval_accumulation_steps=16`` at
    train.py:283; predictions are O(N*C*H*W) while per-sample errors are
    O(N)): call ``per_sample(preds_chunk, labels_chunk)`` per batch,
    concatenate the returned vectors per key, and get the identical stats
    from ``from_samples`` — medians/means are computed over the full
    per-sample error population, never over chunk statistics.
    """

    def __init__(self, channel_slice_list: Sequence[int],
                 channel_names: Sequence[str], absolute: bool = False,
                 full_data: bool = False):
        self.slices = list(channel_slice_list)
        self.names = list(channel_names)
        self.absolute = absolute
        self.full_data = full_data

    @property
    def groups(self) -> int:
        return len(self.slices) - 1

    def per_sample(self, preds, targets) -> Dict[str, np.ndarray]:
        """Per-sample error vectors for one chunk: key ``{group}/relative``
        (and ``{group}/absolute`` when enabled) -> (n_chunk,) array."""
        preds = np.asarray(preds)
        targets = np.asarray(targets)
        out = {}
        for i in range(self.groups):
            lo, hi = self.slices[i], self.slices[i + 1]
            name = self.names[i] if self.groups > 1 else ""
            out[f"{name}/relative"] = relative_lp_error(
                preds[:, lo:hi], targets[:, lo:hi], p=1, return_percent=True)
            if self.absolute:
                out[f"{name}/absolute"] = lp_error(
                    preds[:, lo:hi], targets[:, lo:hi], p=1)
        return out

    def from_samples(self, samples: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Stat battery from (concatenated) per-sample error vectors."""
        rel_stats, abs_stats = [], []
        rels, abss = [], []
        for i in range(self.groups):
            name = self.names[i] if self.groups > 1 else ""
            errs = np.asarray(samples[f"{name}/relative"])
            rels.append(errs)
            rel_stats.append(error_statistics(errs, "relative_l1_error"))
            if self.absolute:
                a = np.asarray(samples[f"{name}/absolute"])
                abss.append(a)
                abs_stats.append(error_statistics(a, "l1_error"))

        if self.groups == 1:
            out = dict(rel_stats[0])
            if self.absolute:
                out.update(abs_stats[0])
            if self.full_data:
                out["relative_full_data"] = rels[0].tolist()
                if self.absolute:
                    out["full_data"] = abss[0].tolist()
            return out

        out: Dict[str, float] = {
            "mean_relative_l1_error": float(
                np.mean([s["mean_relative_l1_error"] for s in rel_stats])),
            "mean_over_median_relative_l1_error": float(
                np.mean([s["median_relative_l1_error"] for s in rel_stats])),
        }
        if self.absolute:
            out["mean_l1_error"] = float(
                np.mean([s["mean_l1_error"] for s in abs_stats]))
            out["mean_over_median_l1_error"] = float(
                np.mean([s["median_l1_error"] for s in abs_stats]))
        for i, name in enumerate(self.names):
            for k, v in rel_stats[i].items():
                out[f"{name}/{k}"] = v
            if self.absolute:
                for k, v in abs_stats[i].items():
                    out[f"{name}/{k}"] = v
            if self.full_data:
                out[f"{name}/relative_full_data"] = rels[i].tolist()
                if self.absolute:
                    out[f"{name}/full_data"] = abss[i].tolist()
        return out

    def __call__(self, preds, targets) -> Dict[str, float]:
        return self.from_samples(self.per_sample(preds, targets))


def compute_channel_group_metrics(
    preds,
    targets,
    channel_slice_list: Sequence[int],
    channel_names: Sequence[str],
) -> Dict[str, float]:
    """Full per-channel-group metric battery of the reference training script
    (train.py:344-398): per-group relative-L1 stats plus cross-group means.

    Args:
        preds, targets: (N, C, H, W).
        channel_slice_list: cumulative group boundaries, e.g. (0, 1, 3, 4).
        channel_names: printable name per group, e.g. ("rho", "uv", "p").
    """
    return ChannelGroupMetrics(channel_slice_list, channel_names)(preds, targets)
