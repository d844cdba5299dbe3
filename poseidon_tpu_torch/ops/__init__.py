"""The hand-written kernels' ops (``window_attention``, ``mlp``) and their
launch counters: each wrapper adds one to its counter where it launches
its kernel, and nowhere else."""

from . import mlp as _mlp
from . import window_attention as _wa
from .window_attention import fused_window_attention

# (kernel name, wrapper, counter attribute) of every hand-written kernel.
COUNTERS = (
    ("window_attention_fwd", _wa.window_attention, "launches"),
    ("window_attention_bwd", _wa.window_attention_bwd, "launches"),
    ("fused_mlp_fwd", _mlp.mlp, "launches"),
    ("fused_mlp_bwd", _mlp.mlp_bwd, "launches"),
    ("fused_window_attention_fwd", _wa.fused_window_attention, "launches"),
    ("fused_window_attention_bwd", _wa.fused_window_attention_bwd, "launches"),
    ("mlp_cln_fwd", _mlp.mlp_cln, "launches"),
    ("mlp_cln_bwd", _mlp.mlp_cln_bwd, "launches"),
    ("window_attention_general_fwd", _wa.window_attention, "launches_general"),
    ("window_attention_general_bwd", _wa.window_attention_bwd, "launches_general"),
    ("fused_window_attention_general_fwd", _wa.fused_window_attention, "launches_general"),
    ("fused_window_attention_general_bwd", _wa.fused_window_attention_bwd, "launches_general"),
    ("mlp_general_fwd", _mlp.mlp, "launches_general"),
    ("mlp_general_bwd", _mlp.mlp_bwd, "launches_general"),
    ("mlp_cln_general_fwd", _mlp.mlp_cln, "launches_general"),
    ("mlp_cln_general_bwd", _mlp.mlp_cln_bwd, "launches_general"),
)


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for _, wrapper, field in COUNTERS:
        setattr(wrapper, field, 0)


def launch_counts() -> dict:
    """Every kernel's launches since the last reset, by kernel name."""
    return {name: getattr(wrapper, field) for name, wrapper, field in COUNTERS}


__all__ = ["fused_window_attention", "COUNTERS", "reset_launch_counts", "launch_counts"]
