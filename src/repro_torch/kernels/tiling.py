"""Launch shapes of the Hopper kernels, in one table.

The TPU package tiles points and stratum slots into large VMEM blocks for a
sequential grid; none of that carries over.  On Hopper the edge kernels are
memory-bound streams, so a block is a multiple of the 32-thread warp and
the grid is either one thread per element (capped, with a grid-stride loop)
or, for the deterministic moment sums of edge_reduce and stratified_stats,
one warp per chunk of a segment's sorted run, where the TPU tiled one-hot
(512, 512) blocks.  The edge megakernel sorts tiles of the window in shared
memory (``MEGA_TILE``); flash attention tiles queries and keys in shared
memory (``FLASH_BLOCK``).
"""

from __future__ import annotations

# kernel name -> threads per block
THREADS: dict[str, int] = {
    "geohash": 256,
    "sample_mask": 512,
    "edge_reduce": 256,
    "stratified_stats": 256,
}

# grid-stride kernels launch at most this many blocks per SM; sample_mask
# copies the fraction table into shared memory once per block, so it runs
# few, long-lived blocks.  The edge megakernel's tiles fill whole waves of
# this many blocks an SM.
BLOCKS_PER_SM: dict[str, int] = {
    "geohash": 16,
    "sample_mask": 2,
    "edge_megakernel": 1,
}

# sorted entries one warp reduces before handing a partial row to the
# per-segment finish pass (bounds the work of the heaviest segment's warps);
# edge_reduce and stratified_stats share it
SEGMENT_CHUNK = 1024

# edge megakernel: at most this many consecutive tuples one block resolves
# and sorts by slot in shared memory (1024 threads x 8), one block per tile
# and member.  A block holds the member's threshold row and the code table
# (52 KB at Geohash-6), later one staged value column, the sort's 48 KB of
# keys and positions and 25 KB of run partials; at 64 registers a thread one
# block fits on an SM (``BLOCKS_PER_SM``), and the tiles come in whole waves
# of them.  The tiles' records take M x S x tiles x (8 + 8 E + 16 C) bytes
# of scratch (83 MB at the main path's 264 tiles).  The CUDA source compiles
# this tile and refuses a larger one.
MEGA_TILE = 8192

# flash attention: (query rows, keys) of a block's tile, where the TPU used
# 256 x 256 VMEM blocks.  One block per query tile and head.  On bf16 inputs
# one warpgroup of 4 warps x 16 query rows runs wgmma, and one producer warp
# loads the query tile and a ring of two key/value stages with TMA (41 KB of
# shared memory at head_dim 64, 81 KB at 112 and 128); on f32 inputs 256
# threads with f32 tiles of q, k, v and the softmax weights (66 KB at
# head_dim 64, 116 KB at 128).  The CUDA source compiles this tile and
# refuses any other.
FLASH_BLOCK = (64, 64)
