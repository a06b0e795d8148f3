"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per TPU kernel of
the main path:

  geohash/      fused quantize + Morton interleave (elementwise)
  sample_mask/  per-stratum fraction gather from shared memory + Bernoulli
                keep mask + Horvitz-Thompson weight
  edge_reduce/  multi-column per-slot moment sums, deterministic (slot sort
                + chunked warp reductions in double), behind
                ``PipelineConfig(backend="pallas")``

Each kernel package holds ``ops.py`` (the wrapper, which launches the CUDA
kernel on a CUDA tensor, and the plain PyTorch version it takes on a CPU
tensor) and ``ref.py`` (a numpy oracle).  The CUDA sources live in
``../csrc``; :mod:`.build` compiles and loads them at first use and counts
launches.  Launch shapes live in :mod:`.tiling`.
"""

from . import build, edge_reduce, geohash, sample_mask, tiling

__all__ = ["build", "edge_reduce", "geohash", "sample_mask", "tiling"]
