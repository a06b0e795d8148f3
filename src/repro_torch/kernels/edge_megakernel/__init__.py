from .ops import MegaResult, edge_megakernel, edge_megakernel_plain

__all__ = ["MegaResult", "edge_megakernel", "edge_megakernel_plain"]
