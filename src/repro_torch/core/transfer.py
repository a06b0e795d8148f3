"""Host values onto the device without waiting on it.

A blocking host-to-device copy (``torch.tensor(x, device=cuda)``, or
``.to(cuda)`` of a pageable CPU tensor) synchronizes the stream: the host
waits until every kernel queued before it has finished.  The query path
moves many small host values (fractions, byte counts, critical values,
window arrays) onto the card, so :func:`to_device` moves them so that the
host never waits: a scalar is written on the device by a fill kernel, and
anything larger crosses in one asynchronous copy from pinned host memory
(PyTorch's host allocator keeps the pinned block until the copy is done).
"""

from __future__ import annotations

import numbers

import numpy as np
import torch


def to_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` (a Python or numpy scalar, a sequence, an array, or a tensor)
    as a ``dtype`` tensor on ``device``; a tensor on a device, or headed
    for one that is not CUDA, moves with a plain ``.to``."""
    device = torch.device(device)
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu" or device.type != "cuda":
            return x.to(device=device, dtype=dtype)
        host = x.to(dtype)
    elif isinstance(x, (numbers.Number, np.generic)):
        return torch.full((), x, dtype=dtype, device=device)
    else:
        # np.array copies, so read-only host buffers convert without a warning
        host = torch.from_numpy(np.array(x)).to(dtype)
        if device.type != "cuda":
            return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)
