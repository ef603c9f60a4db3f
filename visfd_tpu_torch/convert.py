"""Carry arrays between the JAX package's layouts and the port's.

The repository has no weights; what crosses between ``visfd_tpu`` and
``visfd_tpu_torch`` is volumes, filter tables and vector/tensor fields,
all as numpy arrays.  Volumes are (Z, Y, X) in both packages.  A field
that the JAX function returns channel-last, (Z, Y, X, k), is
channel-major (k, Z, Y, X) in the port's fused kernels;
``channels_last=True`` converts between the two.  Flat symmetric
channels keep the order [xx, yy, zz, xy, yz, xz] either way.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(a, device="cpu", channels_last: bool = False) -> torch.Tensor:
    """numpy (or array-like) -> float32 tensor on ``device``; with
    ``channels_last`` a (Z, Y, X, k) field becomes (k, Z, Y, X)."""
    t = torch.tensor(np.asarray(a, dtype=np.float32), device=device)
    return t.movedim(-1, 0).contiguous() if channels_last else t


def to_numpy(t: torch.Tensor, channels_last: bool = False) -> np.ndarray:
    """Tensor -> float32 numpy on the host; with ``channels_last`` a
    channel-major (k, Z, Y, X) field becomes (Z, Y, X, k)."""
    t = t.detach().to("cpu", torch.float32)
    if channels_last:
        t = t.movedim(0, -1)
    return np.ascontiguousarray(t.numpy())
