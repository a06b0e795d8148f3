from .ops import edge_reduce, edge_reduce_plain

__all__ = ["edge_reduce", "edge_reduce_plain"]
