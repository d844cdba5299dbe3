"""``python -m poseidon_tpu_torch.train`` as tests/test_torch_cli_torchrun.py
runs it, with or without ``torchrun``: W&B blocked and the time datasets'
val and test splits cut to a few trajectories, as
tests/test_torch_cli_train.py's ``small_splits`` fixture does in process.

    torchrun --standalone --nproc_per_node 2 tests/_torchrun_train.py <train flags>
"""

import sys

sys.modules["wandb"] = None

import torch.distributed as dist  # noqa: E402

import poseidon_tpu_torch.data.base as pbase  # noqa: E402
from poseidon_tpu_torch import train  # noqa: E402

_post_init = pbase.BaseTimeDataset.post_init


def _small_splits(ds):
    ds.N_max, ds.N_val, ds.N_test = 15000, 4, 8
    _post_init(ds)


if __name__ == "__main__":
    pbase.BaseTimeDataset.post_init = _small_splits
    train.main(sys.argv[1:])
    if dist.is_initialized():
        dist.destroy_process_group()
