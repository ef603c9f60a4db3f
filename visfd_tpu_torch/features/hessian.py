"""Gaussian-scale gradient/Hessian fields and ridge saliency scores.

Port of ``visfd_tpu/features/hessian.py`` (``CalcHessian``,
``feature.hpp:1203-1348``: Gaussian blur then central finite
differences, scaled by sigma / sigma^2; FD stencils from
``visfd_utils.hpp:528-682``, edge voxels taking the stencil of the
nearest interior voxel; scores ``feature.hpp:1526-1612``).  Plain
tensor math; these are the parts the eigen kernel's twin is made of.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from visfd_tpu_torch.linalg import sym3
from visfd_tpu_torch.ops import filters as F


def _edge_clamp(result: torch.Tensor) -> torch.Tensor:
    """Replicate the value at the nearest interior voxel onto the faces
    of the leading (Z, Y, X) axes (``visfd_utils.hpp:592-610``)."""
    for axis in range(3):
        n = result.shape[axis]
        idx = torch.arange(n, device=result.device).clamp(1, n - 2)
        result = result.index_select(axis, idx)
    return result


def _sh(x: torch.Tensor, dz: int, dy: int, dx: int) -> torch.Tensor:
    """x shifted so out[p] = x[p + (dz,dy,dx)], wrapping (the wrapped
    values never survive: _edge_clamp replaces the faces; the gradient's
    shifts)."""
    return torch.roll(x, shifts=(-dz, -dy, -dx), dims=(0, 1, 2))


def gradient_fd(smoothed: torch.Tensor) -> torch.Tensor:
    """Central-difference gradient, (Z, Y, X, 3) in (x, y, z) order."""
    gx = 0.5 * (_sh(smoothed, 0, 0, 1) - _sh(smoothed, 0, 0, -1))
    gy = 0.5 * (_sh(smoothed, 0, 1, 0) - _sh(smoothed, 0, -1, 0))
    gz = 0.5 * (_sh(smoothed, 1, 0, 0) - _sh(smoothed, -1, 0, 0))
    return _edge_clamp(torch.stack([gx, gy, gz], dim=-1))


def hessian_fd_padded(padded: torch.Tensor) -> torch.Tensor:
    """The 3x3 central-difference Hessian, flattened to (Z, Y, X, 6)
    [xx, yy, zz, xy, yz, xz], of the interior of a volume padded by one
    voxel on every face (zeros, or the halo rows of a mesh block); no
    edge clamp."""
    nz, ny, nx = (d - 2 for d in padded.shape)

    def sh(dz, dy, dx):  # out[p] = padded[p + 1 + (dz, dy, dx)]
        return padded[1 + dz:1 + dz + nz, 1 + dy:1 + dy + ny,
                      1 + dx:1 + dx + nx]

    c = sh(0, 0, 0)
    hxx = sh(0, 0, 1) + sh(0, 0, -1) - 2 * c
    hyy = sh(0, 1, 0) + sh(0, -1, 0) - 2 * c
    hzz = sh(1, 0, 0) + sh(-1, 0, 0) - 2 * c
    hxy = 0.25 * (sh(0, 1, 1) + sh(0, -1, -1) - sh(0, -1, 1) - sh(0, 1, -1))
    hyz = 0.25 * (sh(1, 1, 0) + sh(-1, -1, 0) - sh(-1, 1, 0) - sh(1, -1, 0))
    hxz = 0.25 * (sh(1, 0, 1) + sh(-1, 0, -1) - sh(1, 0, -1) - sh(-1, 0, 1))
    return torch.stack([hxx, hyy, hzz, hxy, hyz, hxz], dim=-1)


def gradient_fd_padded(padded: torch.Tensor) -> torch.Tensor:
    """The central-difference gradient, (Z, Y, X, 3) in (x, y, z) order,
    of the interior of a volume padded by one voxel on every face; no
    edge clamp (``gradient_fd``'s floats inside the volume)."""
    nz, ny, nx = (d - 2 for d in padded.shape)

    def sh(dz, dy, dx):  # out[p] = padded[p + 1 + (dz, dy, dx)]
        return padded[1 + dz:1 + dz + nz, 1 + dy:1 + dy + ny,
                      1 + dx:1 + dx + nx]
    return torch.stack([0.5 * (sh(0, 0, 1) - sh(0, 0, -1)),
                        0.5 * (sh(0, 1, 0) - sh(0, -1, 0)),
                        0.5 * (sh(1, 0, 0) - sh(-1, 0, 0))], dim=-1)


def fd_slab(src: torch.Tensor, z0: int, z1: int, y0: int, y1: int,
            org=(0, 0), shape=None, padded_fn=hessian_fd_padded):
    """``fd(S)[z0:z1, y0:y1]`` of a global volume S of (Z, Y, X)
    ``shape``, where fd is ``hessian_fd`` (``padded_fn`` =
    ``hessian_fd_padded``) or ``gradient_fd`` (``gradient_fd_padded``),
    computed from ``src``: the planes and rows of S from ``org`` = (z, y)
    on, all of X (S itself, or a mesh block with a halo of 2).  The same
    floats: every voxel takes the stencil of the nearest voxel at least
    one voxel inside the faces, read from ``src``.  Needs Z, Y, X >= 3."""
    nz, ny, nx = shape if shape is not None else src.shape
    oz, oy = org

    def clamped(a, b, n):
        return torch.arange(a, b, device=src.device).clamp(1, n - 2)
    cz, cy = clamped(z0, z1, nz), clamped(y0, y1, ny)
    cz0, cz1, cy0, cy1 = int(cz[0]), int(cz[-1]), int(cy[0]), int(cy[-1])
    part = src[cz0 - 1 - oz:cz1 + 2 - oz, cy0 - 1 - oy:cy1 + 2 - oy]
    h = padded_fn(torch.nn.functional.pad(part, (1, 1)))
    return (h.index_select(0, cz - cz0).index_select(1, cy - cy0)
            .index_select(2, clamped(0, nx, nx)))


def hessian_fd(smoothed: torch.Tensor) -> torch.Tensor:
    """3x3 central-difference Hessian flattened to (Z, Y, X, 6)
    [xx, yy, zz, xy, yz, xz]."""
    padded = torch.nn.functional.pad(smoothed, (1,) * 6)
    return _edge_clamp(hessian_fd_padded(padded))


def calc_hessian(
    x: torch.Tensor,
    sigma: float,
    mask: Optional[torch.Tensor] = None,
    truncate_ratio: float = 2.5,
    want_gradient: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Blur at scale sigma, then (gradient*sigma, hessian*sigma^2) as
    (Z,Y,X,3) / (Z,Y,X,6) fields, zero where mask == 0."""
    hw = max(1, int(np.floor(sigma * truncate_ratio)))
    smoothed = F.apply_gauss(x, sigma, mask=mask,
                             truncate_halfwidth=(hw,) * 3)
    keep = None if mask is None else (mask != 0)[..., None]
    grad = None
    if want_gradient:
        grad = gradient_fd(smoothed) * sigma
        if keep is not None:
            grad = grad * keep
    hess = hessian_fd(smoothed) * (sigma * sigma)
    if keep is not None:
        hess = hess * keep
    return grad, hess


def diagonalize_hessian_image(
    hess_flat: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    order: sym3.EigenOrder = sym3.EigenOrder.DECREASING_ABS,
) -> torch.Tensor:
    """Voxelwise eigendecomposition of a (Z, Y, X, 6) symmetric-tensor
    field into [eivals(3), shoemake(3)] (``feature.hpp:1364-1471``;
    default ordering there is DECREASING_ABS_EIVALS).  Masked-out
    voxels are zeroed."""
    out = sym3.diagonalize_flat_sym3(hess_flat, order=order)
    if mask is not None:
        out = out * (mask != 0)[..., None]
    return out


def undiagonalize_hessian_image(
    diag: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse voxelwise rebuild (``feature.hpp:1477-1514``)."""
    out = sym3.undiagonalize_flat_sym3(diag)
    if mask is not None:
        out = out * (mask != 0)[..., None]
    return out


def score_hessian_planar(eivals: torch.Tensor) -> torch.Tensor:
    """Ridge "surfaceness" (lambda1^2 - lambda2^2)^2
    (``feature.hpp:1526-1568``)."""
    l1, l2 = eivals[..., 0], eivals[..., 1]
    n = l1 * l1 - l2 * l2
    return n * n


def score_hessian_linear(eivals: torch.Tensor) -> torch.Tensor:
    """Curve-ness lambda1*lambda2 - lambda3^2 (``feature.hpp:1573-1589``)."""
    l1, l2, l3 = eivals[..., 0], eivals[..., 1], eivals[..., 2]
    return l1 * l2 - l3 * l3


def score_tensor_planar(eivals: torch.Tensor) -> torch.Tensor:
    """Stick saliency lambda1 - lambda2 of a vote tensor
    (``feature.hpp:1592-1601``)."""
    return eivals[..., 0] - eivals[..., 1]


def score_tensor_linear(eivals: torch.Tensor) -> torch.Tensor:
    """Curve saliency of a vote tensor (``feature.hpp:1604-1612``)."""
    return score_hessian_linear(eivals)
