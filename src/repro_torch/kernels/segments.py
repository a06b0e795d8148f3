"""Glue of the deterministic moment sums (``csrc/segment_sum.cuh``).

The kernels sum each segment's tuples in a fixed order: this stable sort of
the segment keys, done with PyTorch before the launch, gives every segment
a contiguous run of the permutation, cut into chunks of ``chunk`` entries.
"""

from __future__ import annotations

import torch


def sorted_runs(keys: torch.Tensor, num_segments: int, chunk: int):
    """Stable sort of int32 segment keys in ``[0, num_segments)`` ->
    ``(perm, offsets, chunk_off, max_items)``.

    ``perm`` (int32) lists entry indices grouped by segment; segment ``g``
    owns ``perm[offsets[g]:offsets[g+1]]``, cut into work items numbered
    ``chunk_off[g]`` onwards.  ``max_items`` bounds ``chunk_off[-1]`` from
    the shapes alone, so the launch needs no host sync."""
    dev = keys.device
    sorted_keys, perm = torch.sort(keys, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=torch.int32, device=dev)
    offsets = torch.searchsorted(sorted_keys, bounds, out_int32=True)
    lengths = offsets[1:] - offsets[:-1]
    chunk_off = torch.zeros(num_segments + 1, dtype=torch.int32, device=dev)
    chunk_off[1:] = torch.cumsum((lengths + chunk - 1) // chunk, 0, dtype=torch.int32)
    max_items = num_segments + (keys.shape[0] + chunk - 1) // chunk
    return perm.to(torch.int32), offsets, chunk_off, max_items
