"""High-level 3-D filters: Gaussian, generalized Gaussian, DoG, DoGG,
LoG, local fluctuations (RMS), median.

Port of ``visfd_tpu/ops/filters.py`` (reference ``ApplyGauss``
``filter3d.hpp:1086-1319``, ``ApplyDog`` ``:1340-1402``, ``ApplyLog``
``:1408-1557``, ``LocalFluctuations`` ``:1700-1925``, ``Median``
``:1577-1674``).  Every separable blur goes through
``ops.conv.separable_conv3d`` (``ops.blur_cuda.blur3`` on the card), and
every dense one through ``ops.conv.dense_conv3d`` (``csrc/conv3d.cu``).
Each filter takes a (Z, Y, X) tensor or a ``ShardedVolume``: a sharded
volume is filtered block by block with halos (the separable blur by
``parallel.sharded.separable_conv3d_sharded``, the dense filters and the
median by ``parallel.blocks.map_windows``), with the same values as on
one device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from visfd_tpu_torch.ops import kernels as K
from visfd_tpu_torch.ops.conv import dense_conv3d, separable_conv3d
from visfd_tpu_torch.parallel.mesh import ShardedVolume, bmap

# elements of the median's (voxels, footprint) stack per slab: 2^27 of
# them take 2 GiB with the sorted copy and its int64 indices
MEDIAN_STACK_ELEMENTS = 2 ** 27


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


def apply_gen_gauss(
    x,
    width,
    m_exp: float,
    mask=None,
    truncate_ratio: float = 2.5,
    truncate_halfwidth: Optional[Sequence[int]] = None,
    normalize: bool = True,
):
    """Dense generalized-Gaussian filter h = A*exp(-r^m)
    (``filter3d.hpp:546-638`` + ``Filter3D::Apply``)."""
    w = _sigma3(width)
    if truncate_halfwidth is None:
        hws = tuple(int(np.floor(wi * truncate_ratio)) for wi in w)
    else:
        hws = tuple(int(h) for h in truncate_halfwidth)
    ker = K.gen_gauss_kernel_3d(w, m_exp, hws)
    return dense_conv3d(x, ker, mask=mask, normalize=normalize)


def apply_dogg(
    x,
    width_a,
    width_b,
    m_exp: float,
    n_exp: float,
    mask=None,
    truncate_ratio: float = -1.0,
    truncate_threshold: float = 0.03,
):
    """Difference of generalized Gaussians
    h = A*exp(-(r/a)^m) - B*exp(-(r/b)^n), dense conv, no edge
    normalisation; output is 0 where mask == 0 (``HandleDogg``,
    ``handlers.cpp:265-293`` + ``GenFilterDogg3D``,
    ``filter3d_variants.hpp:440-482``)."""
    ker, _ab = K.dogg_kernel_3d(_sigma3(width_a), _sigma3(width_b),
                                m_exp, n_exp, truncate_ratio,
                                truncate_threshold)
    out = dense_conv3d(x, ker, mask=mask, normalize=False)
    if mask is not None:
        out = bmap(lambda o, m: torch.where(m != 0, o, 0.0), out, mask)
    return out


def apply_dog(
    x,
    sigma_a,
    sigma_b,
    mask=None,
    truncate_halfwidth: Optional[Sequence[int]] = None,
    truncate_ratio: float = 2.5,
    normalize: bool = True,
):
    """Difference of (separately normalised) Gaussians
    (``filter3d.hpp:1340-1402``)."""
    sa, sb = _sigma3(sigma_a), _sigma3(sigma_b)
    if truncate_halfwidth is None:
        truncate_halfwidth = [
            max(1, int(np.floor(truncate_ratio * max(a, b))))
            for a, b in zip(sa, sb)
        ]
    ga = apply_gauss(x, sa, mask, truncate_halfwidth=truncate_halfwidth,
                     normalize=normalize)
    gb = apply_gauss(x, sb, mask, truncate_halfwidth=truncate_halfwidth,
                     normalize=normalize)
    return bmap(torch.sub, ga, gb)


def log_halfwidths(sigma, delta_sigma_over_sigma: float = 0.02,
                   truncate_ratio: float = 2.5):
    """(sigma_a, sigma_b, halfwidths) of ``apply_log``'s two Gaussians."""
    s = _sigma3(sigma)
    d = delta_sigma_over_sigma
    sa = tuple(si * (1.0 - 0.5 * d) for si in s)
    sb = tuple(si * (1.0 + 0.5 * d) for si in s)
    # reference: halfwidth = floor(ratio * max(sa, sb)), NO min-1 clamp
    # (filter3d.hpp:1496-1500); tiny sigmas hit the assert there, so it
    # is clamped to >= 1, which only affects configs the reference
    # rejects
    hw = [max(1, int(np.floor(truncate_ratio * max(a, b))))
          for a, b in zip(sa, sb)]
    return sa, sb, hw


def apply_log(
    x,
    sigma,
    mask=None,
    delta_sigma_over_sigma: float = 0.02,
    truncate_ratio: float = 2.5,
):
    """Scale-normalised Laplacian-of-Gaussian approximated by a DoG at
    sigma*(1 -+ delta/2), multiplied by 1/delta^2
    (``filter3d.hpp:1408-1557``)."""
    d = delta_sigma_over_sigma
    sa, sb, hw = log_halfwidths(sigma, d, truncate_ratio)
    out = apply_dog(x, sa, sb, mask, truncate_halfwidth=hw)
    inv = 1.0 / (d * d)
    return bmap(lambda o: o * inv, out)


def local_fluctuations(
    x,
    sigma,
    mask=None,
    m_exp: float = 2.0,
    truncate_ratio: float = 2.5,
    normalize: bool = True,
):
    """Local RMS intensity fluctuation around the local (Gaussian-
    weighted) mean: sqrt(wpeak * blur((x - blur(x))^2)) where wpeak is
    the peak of the normalised weight kernel
    (``filter3d.hpp:1700-1925``)."""
    s = _sigma3(sigma)
    hws = tuple(int(np.floor(si * truncate_ratio)) for si in s)
    wker = K.gen_gauss_kernel_3d(s, m_exp, hws)
    wpeak = float(wker[hws[2], hws[1], hws[0]])
    if m_exp == 2.0:
        mean = apply_gauss(x, s, mask, truncate_ratio=truncate_ratio,
                           normalize=normalize)
    else:
        mean = dense_conv3d(x, wker, mask=mask, normalize=normalize)
    p2 = bmap(lambda a, b: (a - b) * (a - b), x, mean)
    if m_exp == 2.0:
        var = apply_gauss(p2, s, mask, truncate_ratio=truncate_ratio,
                          normalize=normalize)
    else:
        var = dense_conv3d(p2, wker, mask=mask, normalize=normalize)
    return bmap(lambda v: torch.sqrt(torch.clamp_min(v * wpeak, 0.0)), var)


def local_fluctuations_by_radius(
    x,
    radius,
    mask=None,
    m_exp: float = 2.0,
    truncate_ratio: float = 2.5,
    normalize: bool = True,
):
    """Radius interface: sigma = r / (9*pi/2)^(1/6)
    (``filter3d.hpp:1841-1925``)."""
    r = _sigma3(radius)
    ratio = (4.5 * np.pi) ** (1.0 / 6.0)
    sigma = tuple(ri / ratio for ri in r)
    return local_fluctuations(x, sigma, mask, m_exp, truncate_ratio,
                              normalize)


def sphere_footprint_offsets(radius_xyz) -> np.ndarray:
    """Integer offsets (dz, dy, dx) inside an ellipsoid of the given
    per-axis radius (x, y, z), matching the reference's footprint
    criterion (ix/rx)^2+(iy/ry)^2+(iz/rz)^2 <= 1 used by MedianSphere
    (``filter3d.hpp:1640-1674``)."""
    rx, ry, rz = _sigma3(radius_xyz)
    hx, hy, hz = (int(np.floor(r)) for r in (rx, ry, rz))
    offs = []
    for dz in range(-hz, hz + 1):
        for dy in range(-hy, hy + 1):
            for dx in range(-hx, hx + 1):
                s = 0.0
                s += (dx / rx) ** 2 if rx > 0 else (0.0 if dx == 0 else np.inf)
                s += (dy / ry) ** 2 if ry > 0 else (0.0 if dy == 0 else np.inf)
                s += (dz / rz) ** 2 if rz > 0 else (0.0 if dz == 0 else np.inf)
                if s <= 1.0:
                    offs.append((dz, dy, dx))
    return np.asarray(offs, dtype=np.int32)


def _shift3(x: torch.Tensor, dzyx, fill=0.0) -> torch.Tensor:
    """Shift so out[p] = x[p + d] (neighbour gather), filling
    out-of-bounds with ``fill``."""
    out = x
    for axis, d in enumerate(dzyx):
        if d == 0:
            continue
        n = out.shape[axis]
        pad = [0, 0] * out.ndim
        k = 2 * (out.ndim - 1 - axis)   # F.pad lists the last axis first
        if d > 0:
            pad[k + 1] = d
            start = d
        else:
            pad[k] = -d
            start = 0
        out = torch.nn.functional.pad(out, pad, value=fill).narrow(
            axis, start, n)
    return out


def offsets_halo(offsets) -> Tuple[int, int, int]:
    """(hz, hy, hx): how far the (dz, dy, dx) offsets reach."""
    a = np.abs(np.asarray(offsets, np.int64).reshape(-1, 3))
    return tuple(int(v) for v in a.max(axis=0)) if len(a) else (0, 0, 0)


def window_taps(w: torch.Tensor, offsets, halo):
    """The windows' neighbours at each offset: views of ``w`` (a slab
    window from ``map_windows`` with ``halo`` = (hz, hy, hx)), each of
    the slab's shape."""
    hz, hy, hx = halo
    nz, ny, nx = (w.shape[0] - 2 * hz, w.shape[1] - 2 * hy,
                  w.shape[2] - 2 * hx)
    for dz, dy, dx in offsets:
        yield w[hz + dz:hz + dz + nz, hy + dy:hy + dy + ny,
                hx + dx:hx + dx + nx]


def median_filter(x, radius, mask=None):
    """Median over a spherical footprint.  Out-of-bounds / masked-out
    neighbours are excluded, as in the reference
    (``filter3d.hpp:1577-1674``); where the mask is 0 at the output voxel
    the input is passed through unchanged.

    The JAX package stacks K shifted copies of the whole volume and
    sorts along K; this does the same selection (element
    floor(n_valid / 2) of the sorted values, invalid entries at +inf) in
    z slabs whose (voxels, K) stack holds at most
    ``MEDIAN_STACK_ELEMENTS`` values."""
    offs = [tuple(int(v) for v in o) for o in sphere_footprint_offsets(radius)]
    halo = offsets_halo(offs)
    k = len(offs)
    from visfd_tpu_torch.parallel.blocks import map_windows

    def slab(inb, xw, mw):
        ok = inb if mw is None else inb & (mw != 0)
        taps_ok = list(window_taps(ok, offs, halo))
        vals = torch.stack([torch.where(o, v, torch.inf) for v, o in zip(
            window_taps(xw, offs, halo), taps_ok)], dim=-1)
        nvalid = torch.stack(taps_ok, dim=-1).sum(-1)
        svals = torch.sort(vals, dim=-1).values
        idx = torch.clamp(nvalid // 2, 0, k - 1)
        med = torch.gather(svals, -1, idx[..., None])[..., 0]
        center = next(window_taps(xw, [(0, 0, 0)], halo))
        med = torch.where(nvalid > 0, med, center)
        if mw is not None:
            med = torch.where(next(window_taps(mw, [(0, 0, 0)], halo)) != 0,
                              med, center)
        return med

    return map_windows(slab, [x, mask], [0.0, 0.0], halo,
                       slab_voxels=max(1, MEDIAN_STACK_ELEMENTS // k))

