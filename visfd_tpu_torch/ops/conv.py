"""Separable and dense 3-D convolution over (Z, Y, X) voxel grids, with
the reference's mask and normalisation semantics.

Port of ``visfd_tpu/ops/conv.py``.  The masked
normalised output is ``blur(f*m) / blur(m)`` and the unmasked one
``blur(f) / blur(1)``, where ``blur(1)`` factorises into a per-axis
outer product (``filter3d.hpp:673-683, 1006-1040``).  Every 3-D blur
goes through ``blur_cuda.blur3``: the CUDA kernel for a tensor on the
card, its shift-sum twin on the CPU.

Every dense convolution goes through ``dense_cuda.conv3d_dense``: the
CUDA kernel on the card (no cuDNN, so no TF32), its shift-sum twin on
the CPU; a ``ShardedVolume`` is convolved block by block, each block
read with a halo as deep as the kernel.

``conv1d_axis``, the 1-D pass along one axis, goes through ``blur3``
too, with 1-tap kernels of 1.0 on the other two axes: those passes
multiply by 1.0 and add zeros, which is exact.

Convolution orientation matches the reference: g[i] = sum_j h[j]*f[i-j].
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

import numpy as np

from visfd_tpu_torch.ops import blur_cuda
from visfd_tpu_torch.ops.blur_cuda import blur3
from visfd_tpu_torch.ops.dense_cuda import conv3d_dense
from visfd_tpu_torch.parallel.halo import haloed_block, with_ghosts
from visfd_tpu_torch.parallel.mesh import ShardedVolume, bmap

__all__ = ["conv1d_axis", "dense_conv3d", "separable_conv3d"]


def _ones_denom_1d(kernel: torch.Tensor, n: int) -> torch.Tensor:
    """conv of an all-ones length-n signal with the kernel, zero padded:
    the per-axis normalisation denominator (``filter3d.hpp:1006-1040``)."""
    ones = torch.ones((1, 1, n), dtype=torch.float32, device=kernel.device)
    return blur_cuda.conv1d_axis(ones, kernel, axis=2)[0, 0]


def conv1d_axis(x, kernel, axis: int):
    """1-D convolution g[i] = sum_j h[j] * f[i-j] along ``axis`` (0 = z,
    1 = y, 2 = x) of a (Z, Y, X) volume, zero padded, not normalised;
    the kernel's length is odd.  ``x`` may be a ShardedVolume."""
    k = torch.as_tensor(np.asarray(kernel, np.float32))
    if k.ndim != 1 or k.shape[0] % 2 == 0:
        raise ValueError(f"conv1d_axis takes a 1-D kernel of odd length, "
                         f"got {tuple(k.shape)}")
    one = torch.ones(1, dtype=torch.float32)
    kernels_xyz = [one, one, one]
    kernels_xyz[2 - axis] = k
    if isinstance(x, ShardedVolume):
        # imported here: parallel.sharded imports this module
        from visfd_tpu_torch.parallel.sharded import separable_conv3d_sharded
        return separable_conv3d_sharded(x, kernels_xyz, normalize=False)
    return separable_conv3d(x, kernels_xyz, normalize=False)


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


def _correlate(v, kflip: torch.Tensor):
    """``conv3d_dense`` of a tensor, or of each block of a ShardedVolume
    read with a halo of the kernel's z and y halfwidths (zeros beyond
    the volume), its interior kept."""
    if not isinstance(v, ShardedVolume):
        return conv3d_dense(v, kflip.to(v.device))
    hz, hy = kflip.shape[0] // 2, kflip.shape[1] // 2
    bz, by = v.block_shape
    ghosted = with_ghosts(v, hz, hy)

    def cell(iz, iy, b):
        w = haloed_block(ghosted, iz, iy, hz, 0.0, halo_y=hy)
        return conv3d_dense(w, kflip.to(b.device))[
            hz:hz + bz, hy:hy + by].contiguous()
    return v.with_blocks(cell)


def dense_conv3d(x, kernel_zyx, mask=None, normalize: bool = True):
    """Dense (non-separable) 3-D convolution with the mask/normalise
    semantics of ``Filter3D::Apply`` (``filter3d.hpp:150-458``):
    g = conv(f*m), denominator = conv(m) (or conv(box) without a mask).
    ``x`` (and ``mask``) may be ShardedVolumes."""
    k = torch.as_tensor(np.asarray(kernel_zyx, dtype=np.float32))
    # true convolution: flip all spatial axes, then correlate
    kf = k.flip(0, 1, 2).contiguous()
    src = x if mask is None else bmap(torch.mul, x, mask)
    out = _correlate(src, kf)
    if not normalize:
        return out
    den = _correlate(mask if mask is not None else bmap(torch.ones_like, x),
                     kf)

    def divide(o, d):
        ok = d > 0
        return torch.where(ok, o / torch.where(ok, d, 1.0), o)
    return bmap(divide, out, den)
