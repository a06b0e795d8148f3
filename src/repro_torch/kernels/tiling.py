"""Launch shapes of the Hopper kernels, in one table.

The TPU package tiles points and stratum slots into large VMEM blocks for a
sequential grid; none of that carries over.  On Hopper the edge kernels are
memory-bound streams, so a block is a multiple of the 32-thread warp and
the grid is either one thread per element (capped, with a grid-stride loop)
or, for the deterministic moment sums (edge_reduce, stratified_stats, the
megakernel's sums), one warp per chunk of a segment's sorted run, where the
TPU tiled one-hot (512, 512) blocks.  Flash attention tiles queries and keys in shared memory
(``FLASH_BLOCK``).
"""

from __future__ import annotations

# kernel name -> threads per block
THREADS: dict[str, int] = {
    "geohash": 256,
    "sample_mask": 512,
    "edge_reduce": 256,
    "edge_megakernel": 256,
    "stratified_stats": 256,
}

# grid-stride kernels launch at most this many blocks per SM; sample_mask
# copies the fraction table into shared memory once per block, so it runs
# few, long-lived blocks.  The megakernel's resolve pass holds a member's
# threshold row and the code table in shared memory (52 KB at Geohash-6),
# so four of its blocks fit on an SM; the count is per member (grid.y).
BLOCKS_PER_SM: dict[str, int] = {
    "geohash": 16,
    "sample_mask": 2,
    "edge_megakernel": 4,
}

# sorted entries one warp reduces before handing a partial row to the
# per-segment finish pass (bounds the work of the heaviest segment's warps);
# edge_reduce, stratified_stats and the megakernel's moment sums share it
SEGMENT_CHUNK = 1024

# flash attention: (query rows, keys) of a block's tile, where the TPU used
# 256 x 256 VMEM blocks.  One block per query tile and head: on bf16 inputs
# 4 warps of 16 query rows on the tensor cores, with two buffers of a key
# and a value tile in shared memory (37 KB at head_dim 64, 70 KB at 128); on
# f32 inputs 256 threads with f32 tiles of q, k, v and the softmax weights
# (66 KB at head_dim 64, 116 KB at 128).  The CUDA source compiles this tile
# and refuses any other.
FLASH_BLOCK = (64, 64)
