"""Gaussian blur with mask-aware normalisation.

Port of ``apply_gauss`` from ``visfd_tpu/ops/filters.py``
(reference ``ApplyGauss``, ``filter3d.hpp:1086-1319``).  A sharded
volume (``parallel.mesh.ShardedVolume``) is blurred block by block with
halo exchange, as GSPMD partitions the JAX package's blur.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from visfd_tpu_torch.ops import kernels as K
from visfd_tpu_torch.ops.conv import separable_conv3d
from visfd_tpu_torch.parallel.mesh import ShardedVolume


def _sigma3(sigma) -> Tuple[float, float, float]:
    if np.isscalar(sigma):
        return (float(sigma),) * 3
    s = tuple(float(v) for v in sigma)
    if len(s) != 3:
        raise ValueError(f"sigma needs 1 or 3 values, got {len(s)}")
    return s


def apply_gauss(
    x: torch.Tensor,
    sigma,
    mask: Optional[torch.Tensor] = None,
    truncate_ratio: float = 2.5,
    truncate_halfwidth: Optional[Sequence[int]] = None,
    normalize: bool = True,
) -> torch.Tensor:
    """Separable (possibly anisotropic) Gaussian blur with mask-aware
    normalisation; sigma in voxel units, per-axis order (x, y, z).
    ``x`` (and ``mask``) may be ShardedVolumes."""
    sx, sy, sz = _sigma3(sigma)
    if truncate_halfwidth is None:
        hwx, hwy, hwz = (K.gauss_halfwidth(s, truncate_ratio)
                         for s in (sx, sy, sz))
    else:
        hwx, hwy, hwz = (int(h) for h in truncate_halfwidth)
    kx = K.gauss_kernel_1d(sx, hwx)
    ky = K.gauss_kernel_1d(sy, hwy)
    kz = K.gauss_kernel_1d(sz, hwz)
    if isinstance(x, ShardedVolume):
        # imported here: parallel.sharded imports features.hessian,
        # which imports this module
        from visfd_tpu_torch.parallel.sharded import separable_conv3d_sharded
        return separable_conv3d_sharded(x, (kx, ky, kz), mask=mask,
                                        normalize=normalize)
    return separable_conv3d(x, (kx, ky, kz), mask=mask, normalize=normalize)
