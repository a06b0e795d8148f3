"""Oracle: per-stratum moments in pure numpy.

Numpy-only by contract (edgelint EDG006).  Accumulation is f32 in input
order (``np.add.at``), matching the kernel's accumulation dtype; stratum
indices outside ``[0, num_slots)`` are dropped.
"""

from __future__ import annotations

import numpy as np


def stratified_stats_ref(stratum_idx, values, mask, num_slots: int):
    sidx = np.asarray(stratum_idx).astype(np.int64)
    m = np.asarray(mask).astype(np.float32)
    y = np.asarray(values).astype(np.float32)
    ok = (sidx >= 0) & (sidx < num_slots)
    sidx, m, y = sidx[ok], m[ok], y[ok]
    count = np.zeros(num_slots, np.float32)
    s1 = np.zeros(num_slots, np.float32)
    s2 = np.zeros(num_slots, np.float32)
    np.add.at(count, sidx, m)
    np.add.at(s1, sidx, m * y)
    np.add.at(s2, sidx, m * y * y)
    return count, s1, s2
