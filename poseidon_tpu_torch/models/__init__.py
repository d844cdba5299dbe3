from .scot import ScOT, apply_pixel_mask, forward_with_loss, scot_loss

__all__ = ["ScOT", "apply_pixel_mask", "forward_with_loss", "scot_loss"]
