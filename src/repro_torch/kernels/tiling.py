"""Launch shapes of the Hopper kernels, in one table, and the tile planner
of the sorted-tile kernels.

The TPU package tiles points and stratum slots into large VMEM blocks for a
sequential grid; none of that carries over.  On Hopper geohash and
sample_mask are memory-bound streams: a block is a multiple of the 32-thread
warp and the grid is one thread per element (capped, with a grid-stride
loop).  The edge megakernel, edge_reduce and stratified_stats sort tiles of
the window by slot in shared memory (``MEGA_TILE``, ``csrc/tile_runs.cuh``),
planned by :func:`plan_tiles`; flash attention tiles queries and keys in
shared memory (``FLASH_BLOCK``).
"""

from __future__ import annotations

# kernel name -> threads per block
THREADS: dict[str, int] = {
    "geohash": 256,
    "sample_mask": 512,
}

# grid-stride kernels launch at most this many blocks per SM; sample_mask
# copies the fraction table into shared memory once per block, so it runs
# few, long-lived blocks.  The sorted-tile kernels' tiles fill whole waves
# of this many blocks an SM.
BLOCKS_PER_SM: dict[str, int] = {
    "geohash": 16,
    "sample_mask": 2,
    "edge_megakernel": 1,
    "edge_reduce": 1,
    "stratified_stats": 1,
}

# sorted-tile kernels: at most this many consecutive tuples one block sorts
# by slot in shared memory (1024 threads x 8), one block per tile (and
# member).  At 64 registers a thread one such block fits on an SM
# (``BLOCKS_PER_SM``).  The megakernel's block also holds the member's
# threshold row and the code table (52 KB at Geohash-6), later one staged
# value column, the sort's 48 KB of keys and positions and 25 KB of run
# partials; edge_reduce's and stratified_stats' the tile's weights, one
# staged value column, the sort's 48 KB and 16 KB of run partials.  The
# megakernel's records take M x S x tiles x (8 + 8 E + 16 C) bytes of
# scratch (83 MB at the main path's 264 tiles).  The CUDA sources compile
# this tile and refuse a larger one.
MEGA_TILE = 8192

# smallest tile while the window is spread over one wave of blocks
MIN_TILE = 1024

# the records of edge_reduce's and stratified_stats' tiles (an int marker
# and 1 + 2C doubles per tile and slot) may take at most this many bytes of
# scratch; 76 MB at the main path's shape (264 tiles, S 6558, C 2)
RECORD_BUDGET = 1 << 30

# flash attention: (query rows, keys) of a block's tile, where the TPU used
# 256 x 256 VMEM blocks.  One block per query tile and head.  On bf16 inputs
# one warpgroup of 4 warps x 16 query rows runs wgmma, and one producer warp
# loads the query tile and a ring of two key/value stages with TMA (41 KB of
# shared memory at head_dim 64, 81 KB at 112 and 128); on f32 inputs 256
# threads with f32 tiles of q, k, v and the softmax weights (66 KB at
# head_dim 64, 116 KB at 128).  The CUDA source compiles this tile and
# refuses any other.
FLASH_BLOCK = (64, 64)


def plan_tiles(n: int, resident: int) -> tuple[int, int]:
    """(tiles, tuples per tile) of a window of ``n`` tuples on a card that
    holds ``resident`` tile blocks at once: tiles of at most ``MEGA_TILE``,
    at least one for each resident block while a tile keeps ``MIN_TILE``
    tuples, and in whole waves of them past one wave, the tuples spread
    evenly.  The plan depends on ``(n, resident)`` alone."""
    if n == 0:
        return 0, 0
    tiles = max(-(-n // MEGA_TILE), min(resident, -(-n // MIN_TILE)))
    if tiles > resident:
        tiles = -(-tiles // resident) * resident
    return tiles, -(-n // tiles)


def record_words(tiles: int, num_slots: int, columns: int) -> tuple[int, int]:
    """Scratch of edge_reduce's records for ``columns`` value columns
    (stratified_stats: 1), in 8-byte words: ``(marker words, all words)``,
    the int32 markers first, then the sums.  Raises ``ValueError`` where the
    records would take more than ``RECORD_BUDGET`` bytes."""
    records = tiles * num_slots
    marker_words = -(-records // 2)
    words = marker_words + records * (1 + 2 * columns)
    if 8 * words > RECORD_BUDGET:
        raise ValueError(
            f"{tiles} tiles x {num_slots} slots x (an int32 marker and {1 + 2 * columns} "
            f"double sums) need {8 * words} bytes of records, above the budget of "
            f"{RECORD_BUDGET} bytes")
    return marker_words, words
