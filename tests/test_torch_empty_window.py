"""The edge megakernel's plain version on a window with no tuples: every
count is zero and every extremum its identity, as the JAX package's numpy
oracle (``repro.kernels.edge_megakernel.ref``) and the port's own give.
The plain version used to fail on such a window (a reshape of zero rows)."""

import numpy as np
import pytest
import torch

from repro.kernels.edge_megakernel.ref import edge_megakernel_ref as jax_ref
from repro_torch.kernels.edge_megakernel import MegaResult, edge_megakernel_plain
from repro_torch.kernels.edge_megakernel.ref import edge_megakernel_ref


@pytest.mark.parametrize("m", [1, 3])
def test_megakernel_plain_on_an_empty_window(m):
    s, c = 9, 2
    vals = np.zeros((c, 0), np.float32)
    ok = np.zeros((m, 0), bool)
    scores = np.zeros((m, 0), np.float32)
    thr = np.full((m, s), 0.5, np.float32)
    sidx = np.zeros((m, 0), np.int32)
    got = edge_megakernel_plain(*(torch.from_numpy(a) for a in (vals, ok, scores, thr)), s,
                                sidx=torch.from_numpy(sidx), ext_idx=(1,), sk_idx=(0,))
    for want in (edge_megakernel_ref(vals, ok, scores, thr, s, sidx=sidx, ext_idx=(1,), sk_idx=(0,)),
                 jax_ref(vals, ok, scores, thr, s, sidx=sidx, ext_idx=(1,), sk_idx=(0,))):
        for name, g, w in zip(MegaResult._fields, got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert not got.pop.any() and not got.bins.any()
    assert torch.isposinf(got.mins).all() and torch.isneginf(got.maxs).all()
