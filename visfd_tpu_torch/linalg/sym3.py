"""Batched closed-form symmetric 3x3 eigendecomposition and the compact
rotation codecs: the plain math behind the eigen kernels' twins, the
``-connect`` gates and the ``-load-progress`` scores.

Port of ``visfd_tpu/linalg/sym3.py`` (``eigen3_simple.hpp:36-342``:
trigonometric roots of the characteristic polynomial, the null-space
direction of ``A - lambda I`` from cross products of its columns;
``lin3_utils.hpp:225-377``: quaternion and Shoemake codecs).
Branch-free tensor math over (..., 3, 3) arrays: every reference branch
is a ``torch.where``.

Flat symmetric-6 layout: [xx, yy, zz, xy, yz, xz]
(``lin3_utils.hpp:400-404``).  As in the reference, the eigenvector
matrix holds the eigenvectors in its ROWS, and the "diagonalized flat"
6-vector is [eival0, eival1, eival2, shoemake0, shoemake1, shoemake2]
after a det > 0 fix-up (row 0 negated when det < 0).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

_TINY = float(np.finfo(np.float32).tiny)
_TWO_PI = 2.0 * np.pi


class EigenOrder(enum.Enum):
    """Eigenvalue orderings (``eigen3_simple.hpp:36-43``)."""

    INCREASING = "increasing"
    DECREASING = "decreasing"
    INCREASING_ABS = "increasing_abs"
    DECREASING_ABS = "decreasing_abs"
    INCREASINGLY_DISTINCT = "increasingly_distinct"
    DECREASINGLY_DISTINCT = "decreasingly_distinct"


def full_to_flat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 6) flat [xx, yy, zz, xy, yz, xz]."""
    return torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2],
                        m[..., 0, 1], m[..., 1, 2], m[..., 0, 2]], dim=-1)


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
    scaled, shift, safe = _shifted_scaled(mat)
    vals = _compute_roots3(scaled)  # increasing
    lam_p = vals[..., 2] if order == EigenOrder.DECREASING else vals[..., 0]
    v1, _ = _extract_kernel3(scaled - lam_p[..., None, None] * eye)

    vals = vals * safe[..., None] + shift[..., None]
    if order == EigenOrder.DECREASING:
        vals = vals.flip(-1)
    return vals, v1


def _normalize(v: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / torch.clamp(n, min=_TINY)


def _shifted_scaled(mat: torch.Tensor):
    """(scaled, shift, safe): ``mat`` less its mean eigenvalue, divided
    by its largest entry (1 where that is 0)."""
    eye = torch.eye(3, dtype=mat.dtype, device=mat.device)
    shift = (mat[..., 0, 0] + mat[..., 1, 1] + mat[..., 2, 2]) / 3.0
    scaled = mat - shift[..., None, None] * eye
    scale = scaled.abs().amax(dim=(-2, -1))
    safe = torch.where(scale > 0, scale, 1.0)
    return scaled / safe[..., None, None], shift, safe


def diagonalize_sym3(mat: torch.Tensor,
                     order: EigenOrder = EigenOrder.INCREASING,
                     want_vects: bool = True):
    """Eigenvalues (and row eigenvectors) of (..., 3, 3) symmetric
    matrices, ``DiagonalizeSym3`` (``eigen3_simple.hpp:139-266``).

    Returns (eivals (..., 3), eivects (..., 3, 3) or None):
    ``eivects[..., i, :]`` is the eigenvector of ``eivals[..., i]``.
    Nearly degenerate pairs keep the reference's "orthogonalization",
    which reduces to normalize(rep * (1 - dot(v_k, rep)))
    (``eigen3_simple.hpp:219-228``)."""
    eps = torch.finfo(mat.dtype).eps
    eye = torch.eye(3, dtype=mat.dtype, device=mat.device)
    scaled, shift, safe = _shifted_scaled(mat)
    eivals = _compute_roots3(scaled)  # increasing

    eivects = None
    if want_vects:
        l0, l1, l2 = eivals.unbind(-1)
        # k: the most distinct extreme eigenvalue (0 or 2)
        d0 = l2 - l1
        d1 = l1 - l0
        k_is_0 = d0 > d1
        d_small = torch.minimum(d0, d1)
        d_large = torch.where(k_is_0, d1, d0)
        lam_k = torch.where(k_is_0, l0, l2)
        lam_l = torch.where(k_is_0, l2, l0)

        vk, rep = _extract_kernel3(scaled - lam_k[..., None, None] * eye)
        k_dot_rep = (vk * rep).sum(-1, keepdim=True)
        vl_degen = _normalize(rep * (1.0 - k_dot_rep))
        vl_full, _ = _extract_kernel3(scaled - lam_l[..., None, None] * eye)
        degen = d_small <= (2.0 * eps) * d_large
        vl = torch.where(degen[..., None], vl_degen, vl_full)

        k0 = k_is_0[..., None]
        v0 = torch.where(k0, vk, vl)
        v2 = torch.where(k0, vl, vk)
        v1 = _normalize(torch.linalg.cross(v2, v0))
        # wholly degenerate: all three eigenvalues equal -> identity
        iso = ((l2 - l0) <= eps)[..., None]
        eivects = torch.stack([torch.where(iso, eye[0], v0),
                               torch.where(iso, eye[1], v1),
                               torch.where(iso, eye[2], v2)], dim=-2)

    eivals = eivals * safe[..., None] + shift[..., None]

    # ordering: a conditional swap of the first and last
    # (eigen3_simple.hpp:239-263); the roots come increasing
    l0, l1, l2 = eivals.unbind(-1)
    if order == EigenOrder.INCREASING:
        do_swap = l0 > l2
    elif order == EigenOrder.DECREASING:
        do_swap = l0 < l2
    elif order == EigenOrder.INCREASING_ABS:
        do_swap = l0.abs() > l2.abs()
    elif order == EigenOrder.DECREASING_ABS:
        do_swap = l0.abs() < l2.abs()
    elif order == EigenOrder.INCREASINGLY_DISTINCT:
        do_swap = l1 - l0 > l2 - l1
    elif order == EigenOrder.DECREASINGLY_DISTINCT:
        do_swap = l1 - l0 < l2 - l1
    else:
        raise ValueError(order)
    eivals = torch.where(do_swap[..., None], eivals.flip(-1), eivals)
    if want_vects:
        eivects = torch.where(do_swap[..., None, None], eivects.flip(-2),
                              eivects)
    return eivals, eivects


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion [w, x, y, z], the reference's
    4-branch select (``lin3_utils.hpp:231-269``)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def quat(*parts):
        return torch.stack(parts, dim=-1)

    def branch(diag_sum):
        s = torch.sqrt(torch.clamp(diag_sum, min=0.0)) * 2
        return s, torch.clamp(s, min=_TINY)

    s_a, d_a = branch(tr + 1.0)
    qa = quat(0.25 * s_a, (m21 - m12) / d_a, (m02 - m20) / d_a,
              (m10 - m01) / d_a)
    s_b, d_b = branch(1.0 + m00 - m11 - m22)
    qb = quat((m21 - m12) / d_b, 0.25 * s_b, (m01 + m10) / d_b,
              (m02 + m20) / d_b)
    s_c, d_c = branch(1.0 + m11 - m00 - m22)
    qc = quat((m02 - m20) / d_c, (m01 + m10) / d_c, 0.25 * s_c,
              (m12 + m21) / d_c)
    s_d, d_d = branch(1.0 + m22 - m00 - m11)
    qd = quat((m10 - m01) / d_d, (m02 + m20) / d_d,
              (m12 + m21) / d_d, 0.25 * s_d)
    case_a = (tr > 0)[..., None]
    case_b = ((m00 > m11) & (m00 > m22))[..., None]
    case_c = (m11 > m22)[..., None]
    return torch.where(case_a, qa, torch.where(case_b, qb,
                       torch.where(case_c, qc, qd)))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [w, x, y, z] -> rotation matrix
    (``lin3_utils.hpp:280-311``)."""
    w, x, y, z = q.unbind(-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                        2 * (x * z + y * w)], dim=-1)
    row1 = torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                        2 * (y * z - x * w)], dim=-1)
    row2 = torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                        1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quaternion_to_shoemake(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [w, x, y, z] -> Shoemake coordinates [X0, X1, X2]
    (``lin3_utils.hpp:344-377``)."""
    w, x, y, z = q.unbind(-1)
    r1sq = w * w + x * x
    r2sq = y * y + z * z
    theta1 = torch.where(r1sq > 0, torch.atan2(w, x), 0.0)
    theta2 = torch.where(r2sq > 0, torch.atan2(y, z), 0.0)
    return torch.stack([r2sq, theta1 / _TWO_PI, theta2 / _TWO_PI], dim=-1)


def shoemake_to_quaternion(sm: torch.Tensor) -> torch.Tensor:
    """Shoemake coordinates -> quaternion (``lin3_utils.hpp:311-341``)."""
    x0, x1, x2 = sm.unbind(-1)
    t1, t2 = _TWO_PI * x1, _TWO_PI * x2
    r1 = torch.sqrt(torch.clamp(1.0 - x0, min=0.0))
    r2 = torch.sqrt(torch.clamp(x0, min=0.0))
    return torch.stack([torch.sin(t1) * r1, torch.cos(t1) * r1,
                        torch.sin(t2) * r2, torch.cos(t2) * r2], dim=-1)


def matrix_to_shoemake(m: torch.Tensor) -> torch.Tensor:
    return quaternion_to_shoemake(matrix_to_quaternion(m))


def shoemake_to_matrix(sm: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(shoemake_to_quaternion(sm))


def diagonalize_flat_sym3(flat: torch.Tensor,
                          order: EigenOrder = EigenOrder.INCREASING
                          ) -> torch.Tensor:
    """(..., 6) flat symmetric -> (..., 6) [eivals(3), shoemake(3)]
    (``eigen3_simple.hpp:273-342``).  The Shoemake coordinates encode
    the row-eigenvector matrix after the det > 0 fix-up (row 0 negated
    when det < 0; only the determinant's sign is used)."""
    eivals, ev = diagonalize_sym3(flat_to_full(flat), order=order)
    det = (ev[..., 0, :] * torch.linalg.cross(ev[..., 1, :], ev[..., 2, :])
           ).sum(-1)
    v0 = torch.where((det < 0)[..., None], -ev[..., 0, :], ev[..., 0, :])
    ev = torch.cat([v0[..., None, :], ev[..., 1:, :]], dim=-2)
    return torch.cat([eivals, matrix_to_shoemake(ev)], dim=-1)


def undiagonalize_flat_sym3(diag: torch.Tensor) -> torch.Tensor:
    """Inverse of diagonalize_flat_sym3: rebuild the flat symmetric
    matrix sum_d eival_d * v_d v_d^T from [eivals, shoemake]
    (``eigen3_simple.hpp:348-388``)."""
    eivals = diag[..., :3]
    ev = shoemake_to_matrix(diag[..., 3:6])  # rows = eigenvectors
    m = torch.einsum("...d,...di,...dj->...ij", eivals, ev, ev)
    return full_to_flat(m)


def flat_eigenvectors(diag: torch.Tensor):
    """[eivals, shoemake] -> (eivals, row-eigenvector matrix), the
    ``ConvertDiagFlatSym2Evects3`` unpacking
    (``lin3_utils.hpp:566-585``)."""
    return diag[..., :3], shoemake_to_matrix(diag[..., 3:6])
