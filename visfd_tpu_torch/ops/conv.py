"""Separable 3-D convolution over (Z, Y, X) voxel grids, with the
reference's mask and normalisation semantics.

Port of ``visfd_tpu/ops/conv.py`` (the separable part).  The masked
normalised output is ``blur(f*m) / blur(m)`` and the unmasked one
``blur(f) / blur(1)``, where ``blur(1)`` factorises into a per-axis
outer product (``filter3d.hpp:673-683, 1006-1040``).  Every 3-D blur
goes through ``blur_cuda.blur3``: the CUDA kernel for a tensor on the
card, its shift-sum twin on the CPU.

Convolution orientation matches the reference: g[i] = sum_j h[j]*f[i-j].
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from visfd_tpu_torch.ops.blur_cuda import blur3, conv1d_axis

__all__ = ["conv1d_axis", "separable_conv3d"]


def _ones_denom_1d(kernel: torch.Tensor, n: int) -> torch.Tensor:
    """conv of an all-ones length-n signal with the kernel, zero padded:
    the per-axis normalisation denominator (``filter3d.hpp:1006-1040``)."""
    ones = torch.ones((1, 1, n), dtype=torch.float32, device=kernel.device)
    return conv1d_axis(ones, kernel, axis=2)[0, 0]


def separable_conv3d(
    x: torch.Tensor,
    kernels_xyz: Sequence,  # (kx, ky, kz) 1-D kernels
    mask: Optional[torch.Tensor] = None,
    normalize: bool = True,
) -> torch.Tensor:
    """Separable 3-D convolution (``filter3d.hpp:686-1050``):

    * mask given: voxels with mask==0 contribute nothing; non-binary
      mask values act as weights. Output = blur(x*mask) and, when
      normalising, divided by blur(mask) where that is > 0.
    * no mask + normalize: divide by the separable blur of an all-ones
      box (edge correction), a rank-1 outer product per axis.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    kx, ky, kz = (torch.as_tensor(k, dtype=torch.float32, device=x.device)
                  for k in kernels_xyz)
    m = None if mask is None else torch.as_tensor(
        mask, dtype=torch.float32, device=x.device)
    if not normalize:
        return blur3(x if m is None else x * m, (kx, ky, kz))
    if m is None:
        out = blur3(x, (kx, ky, kz))
        dz = _ones_denom_1d(kz, x.shape[0])[:, None, None]
        dy = _ones_denom_1d(ky, x.shape[1])[None, :, None]
        dx = _ones_denom_1d(kx, x.shape[2])[None, None, :]
        return out / (dz * dy * dx)
    out = blur3(x * m, (kx, ky, kz))
    den = blur3(m, (kx, ky, kz))
    ok = den > 0
    return torch.where(ok, out / torch.where(ok, den, 1.0), out)
