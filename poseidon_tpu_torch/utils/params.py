"""Parameter counts, as ``poseidon_tpu/utils/params.py`` (the reference's
``get_num_parameters`` and its variant without the embeddings)."""

from __future__ import annotations

import torch.nn as nn

# The embedding (patch embedding, its norm, mask token, absolute position
# embeddings) and the patch recovery: the optimizer's ``embeddings`` group.
_EMBED_PREFIXES = ("embeddings.", "patch_recovery.")


def get_num_parameters(model: nn.Module) -> int:
    """Number of parameter values of ``model`` (buffers not counted)."""
    return sum(p.numel() for p in model.parameters())


def get_num_parameters_no_embed(model: nn.Module) -> int:
    """As :func:`get_num_parameters`, without the embedding and the patch
    recovery."""
    return sum(p.numel() for name, p in model.named_parameters()
               if not name.startswith(_EMBED_PREFIXES))
