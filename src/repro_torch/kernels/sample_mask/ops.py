"""Bernoulli selection: the CUDA kernel's wrapper and its plain PyTorch version.

``sample_mask`` launches ``csrc/sample_mask.cu`` on CUDA tensors and takes
the plain version on CPU tensors; mask and weight are bit-identical.
"""

from __future__ import annotations

import torch

from .. import build
from ..tiling import BLOCKS_PER_SM, THREADS

# the fraction table lives in one block's shared memory (227 KB on Hopper)
MAX_STRATA = (227 * 1024) // 4


def sample_mask_plain(stratum_idx: torch.Tensor, uniforms: torch.Tensor, fractions: torch.Tensor):
    """(sidx (N,), u (N,), f_k (S,)) -> (mask (N,) bool, weight (N,) f32)."""
    f = fractions.to(torch.float32)[stratum_idx]
    keep = uniforms.to(torch.float32) < f
    weight = torch.where(keep, torch.reciprocal(torch.clamp_min(f, 1e-9)), 0.0)
    return keep, weight


def sample_mask(stratum_idx: torch.Tensor, uniforms: torch.Tensor, fractions: torch.Tensor):
    """(sidx (N,), u (N,), f_k (S,)) -> (mask (N,) bool, weight (N,) f32).

    ``keep = u < f[sidx]``, ``weight = keep ? 1/max(f, 1e-9) : 0``; the CUDA
    kernel on CUDA tensors (a stratum index outside [0, S) is never kept)."""
    tensors = (("stratum_idx", stratum_idx, torch.int32), ("uniforms", uniforms, torch.float32),
               ("fractions", fractions, torch.float32))
    if all(t.device.type == "cpu" for _, t, _ in tensors):
        return sample_mask_plain(stratum_idx, uniforms, fractions)
    for name, t, dtype in tensors:
        if t.device != stratum_idx.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {stratum_idx.device}; got {t.device}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor; got {t.dtype} {tuple(t.shape)}")
    if uniforms.shape != stratum_idx.shape:
        raise ValueError("uniforms and stratum_idx must have one shape")
    s = fractions.shape[0]
    if s > MAX_STRATA:
        raise ValueError(f"sample_mask holds at most {MAX_STRATA} strata in shared memory; got {s}")
    n = stratum_idx.shape[0]
    mask = torch.empty(n, dtype=torch.bool, device=stratum_idx.device)
    weight = torch.empty(n, dtype=torch.float32, device=stratum_idx.device)
    if n == 0:
        return mask, weight  # nothing to launch
    err = build.kernel("sample_mask")(
        stratum_idx.data_ptr(), uniforms.data_ptr(), fractions.data_ptr(), n, s,
        mask.data_ptr(), weight.data_ptr(),
        THREADS["sample_mask"], BLOCKS_PER_SM["sample_mask"] * build.num_sms(stratum_idx.device),
        build.stream_handle(stratum_idx.device),
    )
    build.check(err, "sample_mask")
    build.LAUNCHES["sample_mask"] += 1
    return mask, weight
