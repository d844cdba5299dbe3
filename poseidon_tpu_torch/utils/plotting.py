"""The prediction grid of the reference's ``create_predictions_plot``, as
``poseidon_tpu/utils/plotting.py``: four random samples, one column each,
alternating prediction and label rows, one pair of rows a channel. Saved
as a PNG and logged to W&B when a run is active. ``matplotlib`` and
``wandb`` are imported only when a plot is made."""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np


def create_predictions_plot(predictions: np.ndarray, labels: np.ndarray,
                            out_path: Optional[str] = None,
                            wandb_prefix: Optional[str] = None,
                            seed: int = 0) -> Optional[str]:
    """Plot ``predictions`` against ``labels`` (N >= 4, (N, C, H, W));
    returns ``out_path``."""
    assert predictions.shape[0] >= 4, "need at least 4 samples"
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.axes_grid1 import ImageGrid

    indices = random.Random(seed).sample(range(predictions.shape[0]), 4)
    preds, labs = predictions[indices], labels[indices]
    fig = plt.figure()
    grid = ImageGrid(fig, 111, nrows_ncols=(preds.shape[1] + labs.shape[1], 4),
                     axes_pad=0.1)
    vmax = max(preds.max(), labs.max())
    vmin = min(preds.min(), labs.min())
    for idx, ax in enumerate(grid):
        i, j = idx // 4, idx % 4
        img = preds[j, i // 2] if i % 2 == 0 else labs[j, i // 2]
        ax.imshow(img, cmap="gist_ncar", origin="lower", vmin=vmin, vmax=vmax)
        ax.set_xticks([])
        ax.set_yticks([])
    if out_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    if wandb_prefix is not None:
        try:
            import wandb

            if wandb.run is not None:
                wandb.log({wandb_prefix + "/predictions": wandb.Image(fig)})
        except ImportError:
            pass
    plt.close(fig)
    return out_path
