"""Per-slot moments of one masked column: the CUDA kernel's wrapper and its
plain PyTorch version.

Both compute, for the rows ``[m, m·y, (m·y)·y]`` (``m`` the mask as f32,
``y`` the value as f32; products in f32, the row layout of the reference
kernel), per-slot sums accumulated in double and rounded to f32 once: the
plain version with one ``index_add_``, the kernel
(``csrc/stratified_stats.cu``) deterministically, as edge_reduce's kernel
sums: tiles of the window sorted by slot in shared memory, one record per
tile and slot, the records added over the tiles in order.  Indices outside
``[0, num_slots)``, the ``-1`` padding included, contribute nothing.
Counts agree exactly (for a bool mask) and sums to within an ulp.
"""

from __future__ import annotations

import torch

from .. import build
from ..tiling import BLOCKS_PER_SM, plan_tiles, record_words


def _slot_keys(stratum_idx: torch.Tensor, num_slots: int) -> torch.Tensor:
    """int32 slot per tuple, with every index outside [0, num_slots) mapped
    to the extra segment ``num_slots`` (in the input dtype first, so a wide
    index cannot wrap into range)."""
    inside = (stratum_idx >= 0) & (stratum_idx < num_slots)
    return torch.where(inside, stratum_idx, num_slots).to(torch.int32)


def stratified_stats_plain(stratum_idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                           num_slots: int):
    """-> (count, s1, s2), each (num_slots,) f32."""
    m = mask.to(torch.float32)
    y = values.to(torch.float32)
    my = m * y
    rows = torch.stack([m, my, my * y], 1).to(torch.float64)  # (N, 3)
    keys = _slot_keys(stratum_idx, num_slots)
    acc = torch.zeros((num_slots + 1, 3), dtype=torch.float64, device=rows.device)
    out = acc.index_add_(0, keys, rows)[:num_slots].to(torch.float32)
    return out[:, 0].contiguous(), out[:, 1].contiguous(), out[:, 2].contiguous()


def stratified_stats(stratum_idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                     num_slots: int):
    """-> (count, s1, s2), each (num_slots,) f32: the per-slot sums of the
    masked rows; the CUDA kernel on CUDA tensors, bitwise reproducible.

    ``stratum_idx`` may be any integer dtype, ``values`` f32 or bf16 (other
    float dtypes are cast to f32), ``mask`` bool or float (cast to f32)."""
    if all(t.device.type == "cpu" for t in (stratum_idx, values, mask)):
        return stratified_stats_plain(stratum_idx, values, mask, num_slots)
    dev = stratum_idx.device
    for name, t in (("stratum_idx", stratum_idx), ("values", values), ("mask", mask)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}; got {t.device}")
        if t.dim() != 1 or t.shape != stratum_idx.shape:
            raise ValueError(f"{name} must be 1-D of shape {tuple(stratum_idx.shape)}; "
                             f"got {tuple(t.shape)}")
    if stratum_idx.is_floating_point() or stratum_idx.dtype == torch.bool:
        raise ValueError(f"stratum_idx must be an integer tensor; got {stratum_idx.dtype}")
    if stratum_idx.dtype not in (torch.int32, torch.int64):
        stratum_idx = stratum_idx.to(torch.int64)  # (u)int8/16 and uint32 widen exactly
    if values.dtype not in (torch.float32, torch.bfloat16):
        values = values.to(torch.float32)
    if mask.dtype not in (torch.bool, torch.float32):
        mask = mask.to(torch.float32)
    stratum_idx, values, mask = stratum_idx.contiguous(), values.contiguous(), mask.contiguous()
    s, n = int(num_slots), stratum_idx.shape[0]
    # scratch as edge_reduce's at C = 1; the kernel maps an index outside
    # [0, s) to its "none" key, which is never summed
    tiles, per = plan_tiles(n, BLOCKS_PER_SM["stratified_stats"] * build.num_sms(dev))
    marker_words, words = record_words(tiles, s, 1)
    scratch = torch.empty(words, dtype=torch.float64, device=dev)
    out = torch.empty(3 * s, dtype=torch.float32, device=dev)
    err = build.kernel("stratified_stats")(
        stratum_idx.data_ptr(), values.data_ptr(), mask.data_ptr(),
        int(stratum_idx.dtype == torch.int64), int(values.dtype == torch.bfloat16),
        int(mask.dtype == torch.float32), n, s, tiles, per, scratch.data_ptr(),
        scratch.data_ptr() + 8 * marker_words, out.data_ptr(), build.stream_handle(dev),
    )
    build.check(err, "stratified_stats")
    build.LAUNCHES["stratified_stats"] += 1
    count, s1, s2 = out.split([s, s, s])
    return count, s1, s2
