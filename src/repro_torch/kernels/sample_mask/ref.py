"""Oracle: gather + threshold Bernoulli mask in pure numpy (f32 throughout).

Numpy-only by contract (edgelint EDG006).
"""

from __future__ import annotations

import numpy as np


def sample_mask_ref(stratum_idx, uniforms, fractions):
    f = np.asarray(fractions).astype(np.float32)[np.asarray(stratum_idx)]
    keep = np.asarray(uniforms).astype(np.float32) < f
    w = np.where(keep, np.float32(1.0) / np.maximum(f, np.float32(1e-9)), np.float32(0.0))
    return keep, w.astype(np.float32)
