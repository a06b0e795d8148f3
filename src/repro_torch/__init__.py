"""EdgeApproxGeo in PyTorch for NVIDIA Hopper.

The paper's edge-cloud approximate query engine — geohash stratification,
EdgeSOS sampling, mergeable per-stratum statistics and error-bounded
finalize — with its hot loops as hand-written CUDA kernels (``kernels/``,
sources in ``csrc/``), and the LM substrate's serving path (``models/``,
``configs/``, ``launch/serve.py``; its prefill attention is a hand-written
flash kernel).  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; on CPU tensors every kernel wrapper takes
its plain PyTorch version.
"""

from . import configs, convert, core, data, kernels, models

__all__ = ["configs", "convert", "core", "data", "kernels", "models"]
