"""Multi-column per-slot moment sums: the CUDA kernel's wrapper and its
plain PyTorch version.

Both compute, for the stacked rows ``[m; m·y_c; (m·y_c)·y_c]`` (products in
f32, the row layout of the reference kernel), per-slot sums accumulated in
double and rounded to f32 once: the plain version with one ``index_add_``,
the kernel (``csrc/edge_reduce.cu``) deterministically: tiles of the
window sorted by slot in shared memory, one record per tile and slot, the
records added over the tiles in order.  Counts agree exactly and sums to
within an ulp.  ``stratum_idx`` values lie in ``[0, num_slots)``; the
kernel drops any other.
"""

from __future__ import annotations

import torch

from .. import build
from ..tiling import BLOCKS_PER_SM, plan_tiles, record_words


def _moment_rows(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Stack [m, m·y_c, (m·y_c)·y_c] rows for a (C, N) column block -> (1+2C, N)."""
    m = mask.to(torch.float32)
    v = values.to(torch.float32)
    my = m[None, :] * v
    return torch.cat([m[None, :], my, my * v], 0)


def edge_reduce_plain(stratum_idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                      num_slots: int):
    """-> (count (S,), s1 (C, S), s2 (C, S)) raw per-slot power sums."""
    c = values.shape[0]
    rows = _moment_rows(values, mask)  # (1+2C, N) f32
    acc = torch.zeros((num_slots, rows.shape[0]), dtype=torch.float64, device=rows.device)
    out = acc.index_add_(0, stratum_idx, rows.T.to(torch.float64)).to(torch.float32)
    return out[:, 0], out[:, 1 : 1 + c].T.contiguous(), out[:, 1 + c :].T.contiguous()


def edge_reduce(stratum_idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                num_slots: int):
    """-> (count (S,), s1 (C, S), s2 (C, S)) raw per-slot power sums of the
    masked tuples; the CUDA kernel on CUDA tensors, bitwise reproducible."""
    if all(t.device.type == "cpu" for t in (stratum_idx, values, mask)):
        return edge_reduce_plain(stratum_idx, values, mask, num_slots)
    dev = stratum_idx.device
    for name, t, dtype, dim in (("stratum_idx", stratum_idx, torch.int32, 1),
                                ("values", values, torch.float32, 2),
                                ("mask", mask, torch.bool, 1)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}; got {t.device}")
        if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-D {dtype} tensor; got {t.dtype} {tuple(t.shape)}")
    c, n = values.shape
    if stratum_idx.shape != (n,) or mask.shape != (n,):
        raise ValueError("stratum_idx and mask must be (N,) for values (C, N)")
    s = int(num_slots)
    # scratch: the tiles' records (int32 markers, zeroed by the launch, then
    # the double sums), from the caching allocator; one output buffer
    tiles, per = plan_tiles(n, BLOCKS_PER_SM["edge_reduce"] * build.num_sms(dev))
    marker_words, words = record_words(tiles, s, c)
    scratch = torch.empty(words, dtype=torch.float64, device=dev)
    out = torch.empty((1 + 2 * c) * s, dtype=torch.float32, device=dev)
    err = build.kernel("edge_reduce")(
        stratum_idx.data_ptr(), values.data_ptr(), mask.data_ptr(), n, c, s, tiles, per,
        scratch.data_ptr(), scratch.data_ptr() + 8 * marker_words, out.data_ptr(),
        build.stream_handle(dev),
    )
    build.check(err, "edge_reduce")
    build.LAUNCHES["edge_reduce"] += 1
    count, s1, s2 = out.split([s, c * s, c * s])
    return count, s1.view(c, s), s2.view(c, s)
