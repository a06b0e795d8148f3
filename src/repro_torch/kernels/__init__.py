"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per ported TPU
kernel:

  geohash/      fused quantize + Morton interleave (elementwise)
  sample_mask/  per-stratum fraction gather from shared memory + Bernoulli
                keep mask + Horvitz-Thompson weight
  edge_reduce/  multi-column per-slot moment sums, deterministic (tiles
                sorted by slot in shared memory, per-(tile, slot) records
                in double added over the tiles in order), behind
                ``PipelineConfig(backend="pallas")``
  edge_megakernel/  one pass that resolves each tuple's slot (sidx, or an
                in-kernel geohash encode + code-table search), samples it by
                threshold, sorts tiles of the window by slot in shared
                memory and emits pop/keep/moments/extrema per tile and slot
                (reduced over the tiles in order) and the sketch bins with
                integer atomics, behind ``PipelineConfig(backend="fused")``
  stratified_stats/  per-slot (count, Σy, Σy²) of one masked column (f32 or
                bf16 values, bool or float mask, out-of-range slots dropped),
                deterministic like edge_reduce; the public op
                ``stratified_stats``, on no path of the engine
  flash_attention/  causal attention forward with an online softmax, GQA
                read in place; every layer of the LM prefill

Each kernel package holds ``ops.py`` (the wrapper, which launches the CUDA
kernel on a CUDA tensor, and the plain PyTorch version it takes on a CPU
tensor) and ``ref.py`` (a numpy oracle).  The CUDA sources live in
``../csrc`` (device code shared between kernels in ``*.cuh`` headers);
:mod:`.build` compiles and loads them at first use and counts launches.
Launch shapes and the tile planner of the sorted-tile kernels live in
:mod:`.tiling`.
"""

from . import (build, edge_megakernel, edge_reduce, flash_attention, geohash, sample_mask,
               stratified_stats, tiling)

__all__ = ["build", "edge_megakernel", "edge_reduce", "flash_attention", "geohash",
           "sample_mask", "stratified_stats", "tiling"]
