from .ops import stratified_stats, stratified_stats_plain

__all__ = ["stratified_stats", "stratified_stats_plain"]
