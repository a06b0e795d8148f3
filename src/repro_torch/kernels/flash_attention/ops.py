"""Causal attention forward: the CUDA flash kernel's wrapper and its plain
PyTorch version.

``flash_attention`` launches ``csrc/flash_attention.cu`` on CUDA tensors and
takes the plain version on CPU tensors.  The plain version is the model's
own :func:`~repro_torch.models.layers.chunked_causal_attention`, which casts
the softmax weights to ``v.dtype`` before the product with V.  On bf16
inputs the kernel (wgmma and TMA) rounds them to bf16 once as well, but
from its own online-softmax running max and normalizer, so the two differ
at bf16 rounding (within the reference kernel test's 2e-2); on f32 inputs
it keeps them in f32, as the TPU kernel does, and the two agree within
2e-5.  The scale is ``1/sqrt(dh)`` of the unpadded head_dim.
"""

from __future__ import annotations

import torch

from .. import build
from ..tiling import FLASH_BLOCK

DTYPES = (torch.float32, torch.bfloat16)
# head dims the CUDA source is compiled for
HEAD_DIMS = (16, 32, 64, 112, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_chunk: int = 1024) -> torch.Tensor:
    """q: (B, S, H, dh); k/v: (B, S, K, dh); causal -> (B, S, H, dh), by the
    model's chunked attention with ``min(q_chunk, S)`` query rows a chunk."""
    # imported here: the models package imports this kernel package
    from ...models.layers import chunked_causal_attention

    return chunked_causal_attention(q, k, v, q_chunk=min(q_chunk, q.shape[1]))


def _strides(t: torch.Tensor) -> tuple:
    """Element strides of the (B, S, heads) dimensions; a dimension of size 1
    takes the stride a packed layout would give it (any stride reads the
    same data there, and a tensor map needs one that is a multiple of 8)."""
    st = list(t.stride())
    for d in (2, 1, 0):
        if t.shape[d] == 1:
            st[d] = st[d + 1] * t.shape[d + 1]
    return tuple(st[:3])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_chunk: int = 1024) -> torch.Tensor:
    """q: (B, S, H, dh); k/v: (B, S, K, dh), H a multiple of K; causal ->
    (B, S, H, dh) in q's dtype.  On CUDA tensors the hand-written kernel
    (f32 or bf16, dh in ``HEAD_DIMS``, the last dimension contiguous; bf16
    q, k and v 16-byte aligned with strides that are multiples of 8, as the
    TMA tensor maps need);
    ``q_chunk`` is read only by the plain version."""
    tensors = (("q", q), ("k", k), ("v", v))
    if all(t.device.type == "cpu" for _, t in tensors):
        return flash_attention_plain(q, k, v, q_chunk)
    dev = q.device
    for name, t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}; got {t.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-D float32 or bfloat16 tensor of q's dtype; "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
    b, s, h, dh = q.shape
    kv_heads = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != dh:
        raise ValueError(f"k and v must be (B, S, K, dh) for q {tuple(q.shape)}; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if kv_heads == 0 or h % kv_heads:
        raise ValueError(f"query heads {h} must be a multiple of key/value heads {kv_heads}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} is not one of the kernel's {HEAD_DIMS}")
    strides = [_strides(t) for _, t in tensors]
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in st3) for (_, t), st3 in zip(tensors, strides)):
        raise ValueError("bfloat16 q, k and v are read through TMA tensor maps: their data must "
                         "be 16-byte aligned and their strides multiples of 8 elements")
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out  # nothing to launch
    q_block, kv_block = FLASH_BLOCK
    err = build.kernel("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, kv_heads, dh,
        *strides[0], *strides[1], *strides[2], int(q.dtype == torch.bfloat16),
        1.0 / (dh**0.5), q_block, kv_block, build.stream_handle(dev),
    )
    build.check(err, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out
