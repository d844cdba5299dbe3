"""The hand-written kernels' ops (``window_attention``, ``mlp``,
``cond_layer_norm``) and their launch counters: each wrapper adds one to
its counter where it launches its kernel, and nowhere else but a CUDA
graph's replay, which adds the launches its capture counted
(:func:`add_launch_counts`)."""

from . import mlp as _mlp
from . import norm as _norm
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
    ("cond_layer_norm_fwd", _norm.cond_layer_norm, "launches"),
    ("cond_layer_norm_bwd", _norm.cond_layer_norm_bwd, "launches"),
)


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for _, wrapper, field in COUNTERS:
        setattr(wrapper, field, 0)


def launch_counts() -> dict:
    """Every kernel's launches since the last reset, by kernel name."""
    return {name: getattr(wrapper, field) for name, wrapper, field in COUNTERS}


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (by kernel name, as :func:`launch_counts`) to the
    counters: the launches of a replayed CUDA graph, whose wrappers ran
    only at the capture."""
    for name, wrapper, field in COUNTERS:
        if counts.get(name):
            setattr(wrapper, field, getattr(wrapper, field) + counts[name])


__all__ = ["fused_window_attention", "COUNTERS", "reset_launch_counts", "launch_counts",
           "add_launch_counts"]
