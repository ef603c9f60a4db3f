"""General 2-D filtering (the reference's ``Filter2D`` class).

Port of ``visfd_tpu/ops/filter2d.py`` (``lib/visfd/filter2d.hpp``): a
dense 2-D convolution with the mask and denominator semantics of
``Filter2D::Apply`` (``filter2d.hpp:28-300``), and the kernel
constructors ``GenFilterGenGauss2D`` (``filter2d.hpp:352-435``) and
``GenFilterDogg2D`` (``bin/filter_mrc/filter3d_variants.hpp:120-258``),
float64 host math that gives the JAX package's taps bit for bit.

Applied to a (Z, Y, X) volume, the 2-D filter acts on every Z slice on
its own.  The port runs it as a dense 3-D correlation with a
(1, Ky, Kx) kernel through ``ops.conv.dense_conv3d``: the hand-written
``csrc/conv3d.cu`` on the card, its shift-sum twin on the CPU.  A
z halfwidth of 0 makes that exactly the per-slice 2-D correlation, and
a ``ShardedVolume`` is filtered block by block with a y halo only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from visfd_tpu_torch.ops.conv import dense_conv3d
from visfd_tpu_torch.ops.kernels import halfwidth_from_threshold
from visfd_tpu_torch.parallel.mesh import ShardedVolume, bmap


def gen_gauss_kernel_2d(
    width_xy,
    m_exp: float,
    halfwidth_xy,
    normalize: bool = True,
) -> np.ndarray:
    """(Y, X)-shaped normalised generalized Gaussian
    h = A*exp(-r^m), r = |(x/s_x, y/s_y)|, with the reference's
    corner truncation (``filter2d.hpp:352-407``)."""
    wx, wy = (float(w) for w in width_xy)
    hx, hy = (int(h) for h in halfwidth_xy)
    trunc = 1.0
    for w, hw in ((wx, hx), (wy, hy)):
        h_edge = np.exp(-((hw / w) ** m_exp)) if w > 0 else 1.0
        trunc = min(trunc, h_edge)
    y, x = np.meshgrid(np.arange(-hy, hy + 1, dtype=np.float64),
                       np.arange(-hx, hx + 1, dtype=np.float64),
                       indexing="ij")

    def scaled(v, w):
        if w == 0.0:
            return np.where(v == 0.0, 0.0, np.inf)
        return v / w

    r = np.sqrt(scaled(x, wx) ** 2 + scaled(y, wy) ** 2)
    with np.errstate(over="ignore"):
        h = np.where(np.isinf(r), 0.0, np.exp(-(r ** m_exp)))
    h = np.where(np.abs(h) < trunc, 0.0, h)
    if normalize:
        h = h / h.sum()
    return h.astype(np.float32)


def gauss_kernel_2d(sigma_xy, halfwidth_xy) -> np.ndarray:
    """Ordinary 2-D Gaussian exp(-0.5 r^2) with std sigma
    (= gen-Gauss with width sigma*sqrt(2), m=2;
    ``filter2d.hpp:440-470``)."""
    w = tuple(float(s) * np.sqrt(2.0) for s in sigma_xy)
    return gen_gauss_kernel_2d(w, 2.0, halfwidth_xy)


def dogg_kernel_2d(
    width_a_xy,
    width_b_xy,
    m_exp: float,
    n_exp: float,
    truncate_ratio: float = -1.0,
    truncate_threshold: float = 0.03,
) -> Tuple[np.ndarray, Tuple[float, float]]:
    """Difference of independently normalised 2-D generalized
    Gaussians on the union window (``GenFilterDogg2D``,
    ``filter3d_variants.hpp:120-258``); returns (kernel, (A, B))."""
    wa = tuple(float(w) for w in width_a_xy)
    wb = tuple(float(w) for w in width_b_xy)
    ra = rb = float(truncate_ratio)
    if truncate_ratio < 0.0:
        ra = halfwidth_from_threshold(1.0, m_exp, truncate_threshold)
        rb = halfwidth_from_threshold(1.0, n_exp, truncate_threshold)
    hwa = tuple(int(np.floor(w * ra)) for w in wa)
    hwb = tuple(int(np.floor(w * rb)) for w in wb)
    ka = gen_gauss_kernel_2d(wa, m_exp, hwa)
    kb = gen_gauss_kernel_2d(wb, n_exp, hwb)
    hws = tuple(max(a, b) for a, b in zip(hwa, hwb))
    h = np.zeros((2 * hws[1] + 1, 2 * hws[0] + 1), dtype=np.float32)

    def _paste(dst, src, sign):
        off = [(d - s) // 2 for d, s in zip(dst.shape, src.shape)]
        sl = tuple(slice(o, o + n) for o, n in zip(off, src.shape))
        dst[sl] += sign * src

    _paste(h, ka, 1.0)
    _paste(h, kb, -1.0)
    A = float(ka[hwa[1], hwa[0]])
    B = float(kb[hwb[1], hwb[0]])
    return h, (A, B)


def dense_conv2d(x, kernel_yx, mask=None, normalize: bool = False):
    """Dense 2-D convolution with ``Filter2D::Apply`` semantics
    (``filter2d.hpp:28-300``): g = conv(f*m), optionally divided by
    conv(m) (conv(1) without a mask).  ``x`` may be a (Y, X) image, a
    (Z, Y, X) volume (slice by slice) or a ShardedVolume."""
    k = np.asarray(kernel_yx, np.float32)[None]
    if isinstance(x, ShardedVolume):
        return dense_conv3d(x, k, mask=mask, normalize=normalize)
    x = torch.as_tensor(x, dtype=torch.float32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    m = None
    if mask is not None:
        m = torch.as_tensor(mask, dtype=torch.float32, device=x.device)
        if m.ndim == 2:
            m = m[None]
    out = dense_conv3d(x, k, mask=m, normalize=normalize)
    return out[0] if squeeze else out


def apply_gen_gauss_2d(
    x,
    width_xy,
    m_exp: float,
    mask=None,
    truncate_ratio: float = -1.0,
    truncate_threshold: float = 0.03,
    normalize: bool = True,
):
    """2-D generalized Gaussian filter with the threshold->ratio
    conversion ratio = (-ln t)^(1/m)
    (``filter3d_variants.hpp:47-72``)."""
    tr = truncate_ratio
    if tr < 0:
        tr = halfwidth_from_threshold(1.0, m_exp, truncate_threshold)
    hw = tuple(int(np.floor(float(w) * tr)) for w in width_xy)
    ker = gen_gauss_kernel_2d(width_xy, m_exp, hw)
    return dense_conv2d(x, ker, mask=mask, normalize=normalize)


def apply_dogg_2d(
    x,
    width_a_xy,
    width_b_xy,
    m_exp: float,
    n_exp: float,
    mask=None,
    truncate_ratio: float = -1.0,
    truncate_threshold: float = 0.03,
):
    """2-D difference of generalized Gaussians (no edge
    normalisation), slice by slice over a volume; 0 where mask == 0."""
    ker, _ = dogg_kernel_2d(width_a_xy, width_b_xy, m_exp, n_exp,
                            truncate_ratio, truncate_threshold)
    out = dense_conv2d(x, ker, mask=mask, normalize=False)
    if mask is None:
        return out
    if not isinstance(out, ShardedVolume):
        mask = torch.as_tensor(mask, device=out.device)
    return bmap(lambda o, m: torch.where(m != 0, o, 0.0), out, mask)
