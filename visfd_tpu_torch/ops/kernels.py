"""1-D/3-D filter-kernel generation (host-side, trace-time numpy).

Matches the reference's kernel constructors:

* ``gauss_kernel_1d`` -- discrete Gaussian via modified Bessel
  functions for sigma <= 10 and |i| <= 20, continuous Gaussian
  otherwise, normalized to sum 1 (``filter1d.hpp:409-460``).
* ``gen_gauss_kernel_3d`` -- generalized ("flattened") Gaussian
  exp(-r^m), dense 3-D (``filter3d.hpp:546-638``).

Kernels are computed in float64/longdouble then cast, mirroring the
reference's long-double accumulation.
"""

from __future__ import annotations

import numpy as np
from scipy.special import ive


def gauss_kernel_1d(sigma: float, halfwidth: int) -> np.ndarray:
    """Normalized 1-D Gaussian kernel of length 2*halfwidth+1.

    sigma == 0 yields a Kronecker delta. For small sigma uses the
    discrete Gaussian h[i] = exp(-s^2) * I_|i|(s^2) (the kernel whose
    repeated self-convolution is exactly closed, Lindeberg's discrete
    scale space), switching to a sampled continuous Gaussian when
    sigma > 10 or |i| > 20 where the Bessel recurrence loses accuracy.
    Reference: ``filter1d.hpp:428-460``.
    """
    hw = int(halfwidth)
    i = np.arange(-hw, hw + 1, dtype=np.float64)
    if sigma == 0.0:
        h = (i == 0).astype(np.float64)
    else:
        s2 = float(sigma) * float(sigma)
        # ive(v, x) = iv(v, x) * exp(-x)  =>  exp(-s^2) * I_|i|(s^2)
        discrete = ive(np.abs(i), s2)
        cont = np.exp(-(i * i) / (2.0 * s2)) / np.sqrt(2.0 * s2 * np.pi)
        use_discrete = (sigma <= 10.0) & (np.abs(i) <= 20.0)
        h = np.where(use_discrete, discrete, cont)
    h = h / h.sum()
    return h.astype(np.float32)


def gauss_halfwidth(sigma: float, truncate_ratio: float = 2.5) -> int:
    """Window halfwidth = floor(sigma * ratio), min 1
    (``filter3d.hpp:1240-1247``)."""
    hw = int(np.floor(sigma * truncate_ratio))
    return max(hw, 1)


def halfwidth_from_threshold(sigma: float, m_exp: float, truncate_thresh: float) -> float:
    """Convert a kernel-value cutoff into a truncation ratio for
    generalized Gaussians: h(r) ~ exp(-(r/s)^m) = thresh at
    r = s * (-ln thresh)^(1/m) (``filter3d_variants.hpp:47-120``)."""
    return float((-np.log(truncate_thresh)) ** (1.0 / m_exp))


def dogg_kernel_3d(
    width_a_xyz,
    width_b_xyz,
    m_exp: float,
    n_exp: float,
    truncate_ratio: float = -1.0,
    truncate_threshold: float = 0.03,
) -> np.ndarray:
    """Difference-of-generalized-Gaussians kernel
    h = A*exp(-(r/a)^m) - B*exp(-(r/b)^n), each term independently
    normalized to sum 1 over its own window, then subtracted on the
    union window (zero outside each term's own domain).

    Window selection matches ``GenFilterDogg3D``
    (``filter3d_variants.hpp:440-482``): if ``truncate_ratio < 0`` each
    term gets its own ratio (-ln threshold)^(1/exponent); halfwidth[d]
    = floor(width[d] * ratio). Returns the (Z, Y, X) dense kernel plus
    the (A, B) central peak heights reported to the user
    (``_GenFilterDogg3D``, ``filter3d_variants.hpp:271-383``).
    """
    wa = tuple(float(w) for w in width_a_xyz)
    wb = tuple(float(w) for w in width_b_xyz)
    ra = rb = float(truncate_ratio)
    if truncate_ratio < 0.0:
        ra = halfwidth_from_threshold(1.0, m_exp, truncate_threshold)
        rb = halfwidth_from_threshold(1.0, n_exp, truncate_threshold)
    hwa = tuple(int(np.floor(w * ra)) for w in wa)
    hwb = tuple(int(np.floor(w * rb)) for w in wb)
    ka = gen_gauss_kernel_3d(wa, m_exp, hwa)
    kb = gen_gauss_kernel_3d(wb, n_exp, hwb)
    hws = tuple(max(a, b) for a, b in zip(hwa, hwb))
    h = np.zeros((2 * hws[2] + 1, 2 * hws[1] + 1, 2 * hws[0] + 1),
                 dtype=np.float32)

    def _paste(dst, src, sign):
        # src is (2*hz+1, 2*hy+1, 2*hx+1); center it in dst
        off = [(d - s) // 2 for d, s in zip(dst.shape, src.shape)]
        sl = tuple(slice(o, o + n) for o, n in zip(off, src.shape))
        dst[sl] += sign * src

    _paste(h, ka, 1.0)
    _paste(h, kb, -1.0)
    A = float(ka[hwa[2], hwa[1], hwa[0]])
    B = float(kb[hwb[2], hwb[1], hwb[0]])
    return h, (A, B)


def gen_gauss_kernel_3d(
    width_xyz,
    m_exp: float,
    halfwidth_xyz,
    normalize: bool = True,
) -> np.ndarray:
    """Dense 3-D generalized Gaussian h(r) = A * exp(-r^m) with
    r = |(x/s_x, y/s_y, z/s_z)|, shaped (Z, Y, X) of size
    (2*hz+1, 2*hy+1, 2*hx+1). Reference ``filter3d.hpp:546-638``.

    Corner entries whose value falls below the smallest on-axis edge
    value are zeroed to avoid anisotropic truncation artifacts
    (``filter3d.hpp:556-586``). Width 0 along an axis means a delta
    along that axis. Note for m == 2 the std-dev is width/sqrt(2)
    (reference "width" convention: width = sigma*sqrt(2)).
    """
    widths = tuple(float(w) for w in width_xyz)
    hws = tuple(int(h) for h in halfwidth_xyz)
    # min kernel value along any axis edge -> corner truncation threshold
    trunc = 1.0
    for w, hw in zip(widths, hws):
        h_edge = np.exp(-((hw / w) ** m_exp)) if w > 0 else 1.0
        trunc = min(trunc, h_edge)
    hx, hy, hz = hws
    z, y, x = np.meshgrid(
        np.arange(-hz, hz + 1, dtype=np.float64),
        np.arange(-hy, hy + 1, dtype=np.float64),
        np.arange(-hx, hx + 1, dtype=np.float64),
        indexing="ij",
    )

    def scaled(v, w):
        if w == 0.0:
            # delta along this axis: off-center -> inf (kernel value 0)
            return np.where(v == 0.0, 0.0, np.inf)
        return v / w

    r = np.sqrt(scaled(x, widths[0]) ** 2 + scaled(y, widths[1]) ** 2
                + scaled(z, widths[2]) ** 2)
    with np.errstate(over="ignore"):
        h = np.where(np.isinf(r), 0.0, np.exp(-(r ** m_exp)))
    h = np.where(np.abs(h) < trunc, 0.0, h)
    if normalize:
        h = h / h.sum()
    return h.astype(np.float32)
