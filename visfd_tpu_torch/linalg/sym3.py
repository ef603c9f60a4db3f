"""Batched closed-form symmetric 3x3 eigenvalues and principal
eigenvector: the plain math behind the eigen kernels' twins.

Port of the slice's part of ``visfd_tpu/linalg/sym3.py``
(``eigen3_simple.hpp:47-137``: trigonometric roots of the
characteristic polynomial, then the null-space direction of
``A - lambda I`` from cross products of its columns).  Branch-free
tensor math over (..., 3, 3) arrays.

Flat symmetric-6 layout: [xx, yy, zz, xy, yz, xz]
(``lin3_utils.hpp:400-404``).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

_TINY = float(np.finfo(np.float32).tiny)


class EigenOrder(enum.Enum):
    """Eigenvalue orderings (``eigen3_simple.hpp:36-43``)."""

    INCREASING = "increasing"
    DECREASING = "decreasing"
    INCREASING_ABS = "increasing_abs"
    DECREASING_ABS = "decreasing_abs"
    INCREASINGLY_DISTINCT = "increasingly_distinct"
    DECREASINGLY_DISTINCT = "decreasingly_distinct"


def flat_to_full(f: torch.Tensor) -> torch.Tensor:
    """(..., 6) flat -> (..., 3, 3) symmetric."""
    xx, yy, zz, xy, yz, xz = f.unbind(-1)
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _compute_roots3(m: torch.Tensor) -> torch.Tensor:
    """Trigonometric roots of the characteristic polynomial of a
    (..., 3, 3) symmetric matrix, sorted increasing."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    m10, m20, m21 = m[..., 1, 0], m[..., 2, 0], m[..., 2, 1]
    c0 = (m00 * m11 * m22 + 2.0 * m10 * m20 * m21
          - m00 * m21 * m21 - m11 * m20 * m20 - m22 * m10 * m10)
    c1 = (m00 * m11 - m10 * m10 + m00 * m22 - m20 * m20
          + m11 * m22 - m21 * m21)
    c2 = m00 + m11 + m22

    inv3 = 1.0 / 3.0
    sqrt3 = float(np.sqrt(3.0))
    c2_over_3 = c2 * inv3
    a_over_3 = torch.clamp((c2 * c2_over_3 - c1) * inv3, min=0.0)
    half_b = 0.5 * (c0 + c2_over_3 * (2.0 * c2_over_3 * c2_over_3 - c1))
    q = torch.clamp(a_over_3 ** 3 - half_b * half_b, min=0.0)
    rho = torch.sqrt(a_over_3)
    theta = torch.atan2(torch.sqrt(q), half_b) * inv3
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    r0 = c2_over_3 - rho * (cos_t + sqrt3 * sin_t)
    r1 = c2_over_3 - rho * (cos_t - sqrt3 * sin_t)
    r2 = c2_over_3 + 2.0 * rho * cos_t
    return torch.stack([r0, r1, r2], dim=-1)


def _extract_kernel3(mat: torch.Tensor):
    """Null-space direction of a rank-2 symmetric (..., 3, 3) matrix
    plus a "representative" near-orthogonal vector
    (``eigen3_simple.hpp:88-137``).  Returns (res, representative)."""
    diag = torch.diagonal(mat, dim1=-2, dim2=-1).abs()
    i0 = torch.argmax(diag, dim=-1)  # first max on ties

    def column(idx):
        ix = (idx % 3)[..., None, None].expand(*idx.shape, 3, 1)
        return torch.gather(mat, -1, ix)[..., 0]

    rep = column(i0)
    c0 = torch.linalg.cross(rep, column(i0 + 1))
    c1 = torch.linalg.cross(rep, column(i0 + 2))
    n0 = (c0 * c0).sum(-1, keepdim=True)
    n1 = (c1 * c1).sum(-1, keepdim=True)
    use0 = n0 > n1
    c = torch.where(use0, c0, c1)
    n = torch.where(use0, n0, n1)
    return c / torch.sqrt(torch.clamp(n, min=_TINY)), rep


def principal_sym3(mat: torch.Tensor,
                   order: EigenOrder = EigenOrder.DECREASING):
    """Eigenvalues and only the principal (first-in-order) eigenvector
    of (..., 3, 3) symmetric matrices.

    Returns (eivals (..., 3) in ``order``, v1 (..., 3)); v1's sign is
    free."""
    if order not in (EigenOrder.INCREASING, EigenOrder.DECREASING):
        raise ValueError("principal_sym3 supports INCREASING/DECREASING")
    eye = torch.eye(3, dtype=mat.dtype, device=mat.device)
    shift = (mat[..., 0, 0] + mat[..., 1, 1] + mat[..., 2, 2]) / 3.0
    scaled = mat - shift[..., None, None] * eye
    scale = scaled.abs().amax(dim=(-2, -1))
    safe = torch.where(scale > 0, scale, 1.0)
    scaled = scaled / safe[..., None, None]

    vals = _compute_roots3(scaled)  # increasing
    lam_p = vals[..., 2] if order == EigenOrder.DECREASING else vals[..., 0]
    v1, _ = _extract_kernel3(scaled - lam_p[..., None, None] * eye)

    vals = vals * safe[..., None] + shift[..., None]
    if order == EigenOrder.DECREASING:
        vals = vals.flip(-1)
    return vals, v1
