"""Launch shapes of the Hopper kernels, in one table.

The TPU package tiles points and stratum slots into large VMEM blocks for a
sequential grid; none of that carries over.  On Hopper every kernel here is
a memory-bound stream, so a block is a multiple of the 32-thread warp and
the grid is either one thread per element (capped, with a grid-stride loop)
or, for edge_reduce, one warp per chunk of a slot's sorted run.
"""

from __future__ import annotations

# kernel name -> threads per block
THREADS: dict[str, int] = {
    "geohash": 256,
    "sample_mask": 512,
    "edge_reduce": 256,
}

# grid-stride kernels launch at most this many blocks per SM; sample_mask
# copies the fraction table into shared memory once per block, so it runs
# few, long-lived blocks
BLOCKS_PER_SM: dict[str, int] = {
    "geohash": 16,
    "sample_mask": 2,
}

# edge_reduce: sorted tuples one warp reduces before handing a partial row
# to the per-slot finish pass (bounds the work of the heaviest slot's warps)
EDGE_REDUCE_CHUNK = 1024
