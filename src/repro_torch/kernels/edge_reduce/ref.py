"""Oracle: stacked per-slot power sums in pure numpy.

Numpy-only by contract (edgelint EDG006).  The rows are formed in f32 as
the kernel forms them and summed in input order with ``np.add.at`` in f32;
order-of-summation differences against the device are covered by the
parity tolerances.
"""

from __future__ import annotations

import numpy as np


def edge_reduce_ref(stratum_idx, values, mask, num_slots: int):
    """-> (count (S,), s1 (C, S), s2 (C, S)) raw per-slot power sums."""
    sidx = np.asarray(stratum_idx).astype(np.int64)
    m = np.asarray(mask).astype(np.float32)
    v = np.asarray(values).astype(np.float32)
    c = v.shape[0]
    my = m[None, :] * v
    rows = np.concatenate([m[None, :], my, my * v], axis=0)  # (1+2C, N)
    out = np.zeros((num_slots, rows.shape[0]), np.float32)
    np.add.at(out, sidx, rows.T)
    return out[:, 0], out[:, 1 : 1 + c].T, out[:, 1 + c :].T
