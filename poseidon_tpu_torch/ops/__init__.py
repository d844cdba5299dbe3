from .window_attention import fused_window_attention

__all__ = ["fused_window_attention"]
