from .ops import sample_mask, sample_mask_plain

__all__ = ["sample_mask", "sample_mask_plain"]
