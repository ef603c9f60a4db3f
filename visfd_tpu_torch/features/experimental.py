"""Experimental filter_mrc operations (the reference's
``handlers_unsupported.cpp``).

Port of ``visfd_tpu/features/experimental.py``:

* :func:`distance_to_points` -- ``HandleDistanceToPoints``
  (``handlers_unsupported.cpp:1393-1466``), on the tensor's device;
* :func:`distance_points_to_feature` --
  ``HandleDistancePointsToFeature`` (``:1470-1551``): the squared
  distances' minima on the device, the rest on the host;
* :func:`random_spheres` -- ``HandleRandomSpheres`` (``:1569-1665``),
  host numpy;
* :func:`blob_radial_intensity` -- ``BlobIntensityProfile``
  (``feature_unsupported.hpp:483-600``), host numpy;
* :func:`template_gen_gauss` -- ``HandleTemplateGauss`` (``:787-1061``):
  the background through ``apply_gauss`` (``csrc/blur.cu``) or the dense
  kernel, the amplitude through the dense kernel (``csrc/conv3d.cu``);
* :func:`dogg_xy` -- ``HandleDoggXY`` (``:19-160``): a z pass through
  ``ops.conv.conv1d_axis`` (``csrc/blur.cu``), then a dense 2-D pass.

The two host functions are the JAX package's numpy code: the seeded
``default_rng`` draws and the raster tie order are the same, so the
centres, the occupancy image and the profiles are equal.  The filters
take a (Z, Y, X) tensor or a ``ShardedVolume``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from visfd_tpu_torch.ops import kernels as K
from visfd_tpu_torch.ops.conv import conv1d_axis, dense_conv3d
from visfd_tpu_torch.ops.filters import apply_gauss
from visfd_tpu_torch.parallel.mesh import ShardedVolume, bmap
from visfd_tpu_torch.utils.transfer import to_device

# volume elements of the (points, selected voxels) squared-distance block
# that distance_points_to_feature builds at a time
PAIR_ELEMENTS = 2 ** 26


# ---------------------------------------------------------------------------
# distance maps
# ---------------------------------------------------------------------------

def distance_to_points(
    shape_zyx: Tuple[int, int, int],
    points_ixyz: np.ndarray,
    voxel_width: float = 1.0,
    mask=None,
    background=None,
    device="cuda",
) -> torch.Tensor:
    """Per-voxel Euclidean distance (in physical units) to the nearest
    of ``points_ixyz`` (integer voxel coordinates, (N, 3) as
    (ix, iy, iz)), a (Z, Y, X) float32 tensor on ``device``.
    Out-of-mask voxels keep ``background`` (or 0).  Reference:
    ``handlers_unsupported.cpp:1436-1464``.

    The JAX package's arithmetic, bit for bit: int32 squared distances
    (three broadcast 1-D squared differences per point, the running
    minimum taken in place), converted to float32, a correctly rounded
    float32 square root (taken in float64 and rounded, which is exact:
    53 >= 2 * 24 + 2 bits), times the voxel width in float32."""
    device = torch.device(device)
    nz, ny, nx = (int(v) for v in shape_zyx)
    pts = torch.as_tensor(np.asarray(points_ixyz, np.int32).reshape(-1, 3),
                          device=device)
    axes = [torch.arange(n, dtype=torch.int32, device=device)
            for n in (nx, ny, nz)]
    dmin = torch.full((nz, ny, nx), np.iinfo(np.int32).max, dtype=torch.int32,
                      device=device)
    d2 = torch.empty_like(dmin)
    for p in pts.split(256):
        # (points, n) squared differences along each axis
        sx, sy, sz = ((a[None, :] - p[:, j, None]) ** 2
                      for j, a in enumerate(axes))
        for i in range(p.shape[0]):
            dzy = sz[i][:, None] + sy[i][None, :]
            torch.add(dzy[:, :, None], sx[i][None, None, :], out=d2)
            torch.minimum(dmin, d2, out=dmin)
    del d2
    out = torch.sqrt(dmin.to(torch.float32).double()).float()
    del dmin
    out.mul_(float(np.float32(voxel_width)))
    if mask is not None:
        m = to_device(np.asarray(mask) != 0, device)
        bg = (torch.zeros((), dtype=torch.float32, device=device)
              if background is None else
              to_device(background, device, dtype=torch.float32))
        out = torch.where(m, out, bg)
    return out


def distance_points_to_feature(
    source,
    points_ixyz: np.ndarray,
    select_min: float,
    select_max: float,
    voxel_width: float = 1.0,
    mask=None,
    device="cuda",
) -> np.ndarray:
    """For each point, the distance (physical units) to the nearest
    voxel whose brightness lies in [select_min, select_max] (and is
    in-mask), float32 on the host; ``inf`` for every point when no
    voxel is selected.  The int64 squared distances' minima are taken
    on ``device`` in blocks of points; the square root and the voxel
    width are the JAX package's host expression.  Reference:
    ``handlers_unsupported.cpp:1470-1551``."""
    device = torch.device(device)
    src = to_device(source, device)
    sel = (src >= select_min) & (src <= select_max)
    if mask is not None:
        sel &= to_device(mask, device) != 0
    pts = np.asarray(points_ixyz, np.int64).reshape(-1, 3)
    vox = torch.nonzero(sel).flip(1)  # (M, 3) as (ix, iy, iz)
    del sel
    if len(vox) == 0:
        return np.full(len(pts), np.inf, np.float32)
    p = torch.as_tensor(pts, device=device)
    step = max(1, PAIR_ELEMENTS // len(vox))
    d2min = torch.cat([((vox[None] - c[:, None]) ** 2).sum(-1).amin(1)
                       for c in p.split(step)]).cpu().numpy()
    return (np.sqrt(d2min) * voxel_width).astype(np.float32)


# ---------------------------------------------------------------------------
# random sphere packing (host)
# ---------------------------------------------------------------------------

def random_spheres(
    source: np.ndarray,
    n_spheres: int,
    diameter_vox: float,
    select_min: float,
    select_max: float,
    seed: int = 0,
    mask: Optional[np.ndarray] = None,
    max_attempts_per_sphere: int = 1_000_000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack ``n_spheres`` non-overlapping spheres of ``diameter_vox``
    into the region where brightness is in [select_min, select_max]
    (and in-mask), by rejection sampling.  Returns
    ``(centers_ixyz (N,3) int, occupancy image)`` where the occupancy
    image is 1 everywhere except the initially-available region (0)
    and placed spheres are painted 1
    (``handlers_unsupported.cpp:1569-1665``).  Host numpy: each draw
    depends on the occupancy the draws before it left, one small window
    at a time."""
    source = np.asarray(source)
    nz, ny, nx = source.shape
    r = int(np.ceil(diameter_vox / 2.0))
    if nx <= 2 * r or ny <= 2 * r or nz <= 2 * r:
        raise ValueError(
            "The image size is smaller than the spheres you want to pack.")
    occ = np.ones(source.shape, np.float32)
    avail = (source >= select_min) & (source <= select_max)
    if mask is not None:
        avail &= np.asarray(mask) != 0
    occ[avail] = 0.0

    dz, dy, dx = np.meshgrid(*[np.arange(-r, r + 1)] * 3, indexing="ij")
    ball = (dz ** 2 + dy ** 2 + dx ** 2) <= r * r

    rng = np.random.default_rng(seed)
    centers = []
    for i in range(n_spheres):
        for attempt in range(max_attempts_per_sphere):
            ix0 = int(rng.integers(r, nx - r))
            iy0 = int(rng.integers(r, ny - r))
            iz0 = int(rng.integers(r, nz - r))
            win = occ[iz0 - r:iz0 + r + 1, iy0 - r:iy0 + r + 1,
                      ix0 - r:ix0 + r + 1]
            if not (win[ball] != 0).any():
                break
        else:
            raise RuntimeError(
                f"random_spheres: could not place sphere {i + 1}/"
                f"{n_spheres} after {max_attempts_per_sphere} attempts")
        centers.append((ix0, iy0, iz0))
        win[ball] = 1.0
    return np.asarray(centers, np.int64).reshape(-1, 3), occ


# ---------------------------------------------------------------------------
# blob radial intensity profiles (host)
# ---------------------------------------------------------------------------

CENTER_MINIMA = "min"
CENTER_MAXIMA = "max"
CENTER_CENTER = "center"


def blob_radial_intensity(
    source: np.ndarray,
    center_xyz: Sequence[float],
    diameter_vox: float,
    center_criteria: str = CENTER_CENTER,
    mask: Optional[np.ndarray] = None,
    radius_profile_width: float = -1.0,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Average intensity vs. integer radius around a blob.

    The profile center is the sphere center, or the darkest/brightest
    in-sphere voxel when ``center_criteria`` is ``min``/``max`` (the
    first such voxel in raster jz->jy->jx window order on ties, like
    the reference).  Bins are ``round(|r|)``; the profile is truncated
    at the first empty bin.  Returns ``(profile, effective_center)``.
    Reference: ``feature_unsupported.hpp:483-600``.  Host numpy: one
    small window per blob."""
    source = np.asarray(source)
    nz, ny, nx = source.shape
    m = None if mask is None else (np.asarray(mask) != 0)
    rs = int(np.ceil(diameter_vox / 2.0))
    ixs = int(np.floor(center_xyz[0] + 0.5))
    iys = int(np.floor(center_xyz[1] + 0.5))
    izs = int(np.floor(center_xyz[2] + 0.5))

    if center_criteria == CENTER_CENTER:
        ix0, iy0, iz0 = ixs, iys, izs
    else:
        best = None
        val = None
        for jz in range(-rs, rs + 1):
            for jy in range(-rs, rs + 1):
                for jx in range(-rs, rs + 1):
                    if jx * jx + jy * jy + jz * jz > rs * rs:
                        continue
                    z, y, x = izs + jz, iys + jy, ixs + jx
                    if not (0 <= z < nz and 0 <= y < ny and 0 <= x < nx):
                        continue
                    if m is not None and not m[z, y, x]:
                        continue
                    v = source[z, y, x]
                    if best is None \
                       or (center_criteria == CENTER_MAXIMA and v > val) \
                       or (center_criteria == CENTER_MINIMA and v < val):
                        best, val = (x, y, z), v
        if best is None:
            return np.zeros(0, np.float32), (ixs, iys, izs)
        ix0, iy0, iz0 = best

    rp = int(np.ceil(rs + np.sqrt((ix0 - ixs) ** 2 + (iy0 - iys) ** 2
                                  + (iz0 - izs) ** 2)))
    if rp < radius_profile_width:
        rp = int(np.floor(radius_profile_width + 0.5))

    num = np.zeros(rp + 1)
    den = np.zeros(rp + 1)
    jz, jy, jx = np.meshgrid(*[np.arange(-rp, rp + 1)] * 3, indexing="ij")
    inside = (jx ** 2 + jy ** 2 + jz ** 2) <= rp * rp
    z, y, x = iz0 + jz, iy0 + jy, ix0 + jx
    ok = inside & (z >= 0) & (z < nz) & (y >= 0) & (y < ny) \
        & (x >= 0) & (x < nx)
    if m is not None:
        ok &= m[np.clip(z, 0, nz - 1), np.clip(y, 0, ny - 1),
                np.clip(x, 0, nx - 1)]
    # distance from the *sphere* center caps the contributing voxels
    Jx, Jy, Jz = jx + ix0 - ixs, jy + iy0 - iys, jz + iz0 - izs
    Jr = np.floor(np.sqrt(Jx ** 2 + Jy ** 2 + Jz ** 2) + 0.5).astype(int)
    ok &= Jr <= rp
    jr = np.floor(np.sqrt(jx ** 2 + jy ** 2 + jz ** 2) + 0.5).astype(int)
    vals = source[np.clip(z, 0, nz - 1), np.clip(y, 0, ny - 1),
                  np.clip(x, 0, nx - 1)]
    np.add.at(num, jr[ok], vals[ok])
    np.add.at(den, jr[ok], 1.0)
    profile = np.zeros(rp + 1, np.float32)
    for ir in range(rp + 1):
        if den[ir] == 0.0:
            profile = profile[:ir]
            break
        profile[ir] = num[ir] / den[ir]
    return profile, (ix0, iy0, iz0)


# ---------------------------------------------------------------------------
# generalized-Gaussian template matching
# ---------------------------------------------------------------------------

def template_gen_gauss(
    x,
    width_a_xyz: Sequence[float],
    background_radius_xyz: Sequence[float],
    m_exp: float = 2.0,
    n_exp: float = 2.0,
    mask=None,
    truncate_ratio: float = 2.5,
    normalize_near_boundaries: bool = True,
):
    """Least-squares amplitude of a generalized-Gaussian template.

    Weights w = gen-Gauss(background_radius, n) with peak 1; template
    Q = gen-Gauss(width_a, m) recentered (Q_ = Q - <Q>_w) and scaled
    so sum(w Q_^2) = 1 (float64 host math); background = w-weighted
    local average of x (a plain Gaussian of sigma = background_radius /
    sqrt(3) through ``blur3`` when n = 2, else the dense kernel); output
    voxel = sum_i w_i Q_i (x - background)_i, the fitted template
    amplitude, through the dense kernel
    (``handlers_unsupported.cpp:787-1061``)."""
    if not isinstance(x, ShardedVolume):
        x = torch.as_tensor(x, dtype=torch.float32)
    wr = tuple(float(v) for v in background_radius_xyz)
    wa = tuple(float(v) for v in width_a_xyz)
    hws = tuple(max(1, int(np.floor(r * truncate_ratio))) for r in wr)

    w = K.gen_gauss_kernel_3d(wr, n_exp, hws, normalize=False)  # peak 1
    q = K.gen_gauss_kernel_3d(wa, m_exp, hws, normalize=False)
    qave = float((w * q).sum() / w.sum())
    q_ = q - qave
    q_ = q_ / np.sqrt((w * q_ * q_).sum())

    if n_exp == 2.0:
        bg_sigma = tuple(r / np.sqrt(3.0) for r in wr)
        background = apply_gauss(x, bg_sigma, mask,
                                 normalize=normalize_near_boundaries)
    else:
        background = dense_conv3d(x, w / w.sum(), mask=mask,
                                  normalize=normalize_near_boundaries)
    p = bmap(torch.sub, x, background)
    del background
    return dense_conv3d(p, (w * q_).astype(np.float32), mask=mask,
                        normalize=False)


# ---------------------------------------------------------------------------
# DOGGXY: generalized DoG in XY x Gaussian in Z
# ---------------------------------------------------------------------------

def dogg_xy(
    x,
    width_a_xy: Sequence[float],
    width_b_xy: Sequence[float],
    sigma_z: float,
    m_exp: float = 2.0,
    n_exp: float = 2.0,
    mask=None,
    truncate_ratio: float = 2.5,
):
    """Difference of 2-D generalized Gaussians in the XY plane
    multiplied by an ordinary Gaussian along Z
    (``handlers_unsupported.cpp:19-160``): a zero-padded, unnormalised
    z pass of the unmasked volume, then a dense 2-D XY convolution of
    the normalised-kernel difference, the mask entering there only."""
    if not isinstance(x, ShardedVolume):
        x = torch.as_tensor(x, dtype=torch.float32)
    ax, ay = (float(v) for v in width_a_xy)
    bx, by = (float(v) for v in width_b_xy)
    hx = max(1, int(np.floor(max(ax, bx) * truncate_ratio)))
    hy = max(1, int(np.floor(max(ay, by) * truncate_ratio)))
    # 2-D kernels as z-thickness-1 3-D kernels (delta along z)
    ka = K.gen_gauss_kernel_3d((ax, ay, 0.0), m_exp, (hx, hy, 0))
    kb = K.gen_gauss_kernel_3d((bx, by, 0.0), n_exp, (hx, hy, 0))
    k2 = (ka - kb).astype(np.float32)

    hz = max(1, int(np.floor(sigma_z * truncate_ratio)))
    out = conv1d_axis(x, K.gauss_kernel_1d(sigma_z, hz), 0)
    return dense_conv3d(out, k2, mask=mask, normalize=False)
