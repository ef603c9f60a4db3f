"""Region painting for ``-mask-rect`` and ``-mask-sphere``, and sphere
rendering for ``-blob`` and ``-draw-spheres``.

* ``draw_regions``, ``Rect`` and ``Sphere``: a copy of
  ``visfd_tpu/ops/draw.py`` (``draw.hpp:88-224``): rect and sphere
  primitives painted in order into a host mask; negative values subtract
  voxels from the mask set (with the all-ones initialisation special
  case).  Host numpy: a few primitives painted once, before the volume
  goes to the card.
* ``draw_spheres``: the port of ``draw.hpp:235-465``.  The JAX package
  loops over every voxel of every sphere in Python; here the spheres
  are grouped by shape (the same offset table), their voxels listed
  group by group in torch on the device, and the last sphere written
  wins through a ``scatter_reduce`` "amax" of the sphere index per
  voxel, then one gather of the winners' brightness.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from visfd_tpu_torch.utils.transfer import to_device, to_host

# (sphere, voxel) pairs listed at a time by draw_spheres
PAIRS_PER_CHUNK = 2 ** 25


@dataclasses.dataclass
class Rect:
    xmin: float
    xmax: float
    ymin: float
    ymax: float
    zmin: float
    zmax: float
    value: float = 1.0


@dataclasses.dataclass
class Sphere:
    x0: float
    y0: float
    z0: float
    r: float
    value: float = 1.0


def draw_regions(
    dest: np.ndarray,
    regions: Sequence,
    mask: Optional[np.ndarray] = None,
    negative_means_subtract: bool = False,
) -> np.ndarray:
    """Paint regions into ``dest`` in order (``draw.hpp:88-224``).
    Modifies and returns ``dest``."""
    nz, ny, nx = dest.shape
    valid = None if mask is None else (np.asarray(mask) != 0)

    if negative_means_subtract and regions and regions[0].value < 0:
        sel = valid if valid is not None else np.ones(dest.shape, bool)
        if not (dest[sel] != 0).any():
            dest[sel] = 1.0

    for reg in regions:
        value = reg.value
        if isinstance(reg, Sphere):
            R = reg.r
            ri = int(np.ceil(R - 0.5))
            cx = int(np.floor(reg.x0 + 0.5))
            cy = int(np.floor(reg.y0 + 0.5))
            cz = int(np.floor(reg.z0 + 0.5))
            for jz in range(-ri, ri + 1):
                for jy in range(-ri, ri + 1):
                    descr = R * R - (jy * jy + jz * jz)
                    if descr < 0:
                        continue
                    xr = int(np.floor(np.sqrt(descr)))
                    z, y = cz + jz, cy + jy
                    if not (0 <= z < nz and 0 <= y < ny):
                        continue
                    x0 = max(cx - xr, 0)
                    x1 = min(cx + xr, nx - 1)
                    if x0 > x1:
                        continue
                    row = slice(x0, x1 + 1)
                    ok = np.ones(x1 + 1 - x0, bool)
                    if valid is not None:
                        ok &= valid[z, y, row]
                    if value < 0:
                        if negative_means_subtract:
                            seg = dest[z, y, row]
                            seg[ok & (seg > 0)] = 0.0
                            dest[z, y, row] = seg
                    else:
                        seg = dest[z, y, row]
                        seg[ok] = value
                        dest[z, y, row] = seg
        elif isinstance(reg, Rect):
            ix0 = int(np.floor(reg.xmin + 0.5))
            ix1 = int(np.floor(reg.xmax + 0.5))
            iy0 = int(np.floor(reg.ymin + 0.5))
            iy1 = int(np.floor(reg.ymax + 0.5))
            iz0 = int(np.floor(reg.zmin + 0.5))
            iz1 = int(np.floor(reg.zmax + 0.5))
            zsl = slice(max(iz0, 0), min(iz1, nz - 1) + 1)
            ysl = slice(max(iy0, 0), min(iy1, ny - 1) + 1)
            xsl = slice(max(ix0, 0), min(ix1, nx - 1) + 1)
            box = dest[zsl, ysl, xsl]
            ok = np.ones(box.shape, bool)
            if valid is not None:
                ok &= valid[zsl, ysl, xsl]
            if value < 0:
                if negative_means_subtract:
                    box[ok & (box > 0)] = 0.0
            else:
                box[ok] = value
            dest[zsl, ysl, xsl] = box
        else:
            raise TypeError(f"unknown region type {type(reg)}")
    return dest


def _sphere_offsets(rs: int, r2min: float, r2max: float, device):
    """(dz, dy, dx) of the cube [-rs, rs]^3 with r2min <= r^2 <= r2max,
    as int64 columns."""
    j = torch.arange(-rs, rs + 1, dtype=torch.int64)
    dz, dy, dx = torch.meshgrid(j, j, j, indexing="ij")
    r2 = (dx * dx + dy * dy + dz * dz).to(torch.float64)
    keep = (r2 >= r2min) & (r2 <= r2max)
    return [d[keep].to(device) for d in (dz, dy, dx)]


def draw_spheres(
    dest_shape_zyx: Tuple[int, int, int],
    centers_xyz: np.ndarray,          # (N, 3) float voxel coords
    diameters: Optional[np.ndarray] = None,
    shell_thicknesses: Optional[np.ndarray] = None,
    foreground: Optional[np.ndarray] = None,   # per-sphere brightness
    background=None,                  # (Z, Y, X) image (numpy or tensor)
    mask=None,
    background_offset: float = 0.0,
    background_rescale: float = 1.0,
    background_normalize: bool = False,
    foreground_normalize: bool = False,
    device=None,
    report=None,
) -> torch.Tensor:
    """Render spheres/shells over an (optional) background image
    (``draw.hpp:235-465``) as a (Z, Y, X) float32 tensor on ``device``
    (default: the background's, else the CPU).  Sphere i covers the
    voxels c_i + j of the cube |j| <= ceil(d_i / 2 - 0.5) with
    (d_i / 2 - shell_i)^2 <= |j|^2 <= (d_i / 2)^2 (the inner bound only
    when both terms are positive), c_i truncated toward zero, inside the
    volume and the mask; where spheres overlap the later one wins.  A
    ``Report`` counts the background's and the mask's copies."""
    nz, ny, nx = dest_shape_zyx
    if device is None:
        device = (background.device if isinstance(background, torch.Tensor)
                  else "cpu")
    device = torch.device(device)
    centers_xyz = np.asarray(centers_xyz, np.float64).reshape(-1, 3)
    n = len(centers_xyz)
    diameters = (np.zeros(n) if diameters is None
                 else np.asarray(diameters, np.float64))
    shell = (diameters / 2 if shell_thicknesses is None
             else np.asarray(shell_thicknesses, np.float64))
    foreground = (np.ones(n) if foreground is None
                  else np.asarray(foreground, np.float64))

    valid = (None if mask is None
             else (to_device(mask, device, report) != 0).reshape(-1))
    if background is None:
        dest = torch.zeros(dest_shape_zyx, dtype=torch.float32,
                           device=device)
    elif not background_normalize:
        dest = (to_device(background, device, report).to(torch.float32)
                * background_rescale)
    else:
        # the JAX package's float64 host statistics, for the same bits
        bg = to_host(background, report, np.float64)
        sel = (np.ones(bg.shape, bool) if mask is None else
               to_host(mask, report) != 0)
        ave = bg[sel].mean() if sel.any() else 0.0
        std = bg[sel].std() if sel.any() else 0.0
        rms = np.sqrt(np.mean(np.square(foreground))) if n else 1.0
        if std > 0:
            dest = to_device((((bg - ave) / std) * rms * background_rescale)
                             .astype(np.float32), device, report)
        else:
            dest = torch.zeros(dest_shape_zyx, dtype=torch.float32,
                               device=device)
        del bg
    dest = dest + background_offset
    if n == 0:
        return dest

    cxyz = np.trunc(centers_xyz).astype(np.int64)
    rs = np.maximum(np.ceil(diameters / 2 - 0.5), 0).astype(np.int64)
    r2max = (diameters / 2) ** 2
    inner = (shell > 0) & (diameters / 2 - shell > 0)
    r2min = np.where(inner, (diameters / 2 - shell) ** 2, 0.0)
    shapes = np.stack([rs.astype(np.float64), r2min, r2max], axis=1)
    uniq, group = np.unique(shapes, axis=0, return_inverse=True)
    group = group.reshape(-1)
    idt = torch.int32 if n < 2 ** 31 - 1 else torch.int64
    owner = torch.full((nz * ny * nx,), -1, dtype=idt, device=device)
    counts = np.zeros(n, np.int64)
    for g, (rs_g, lo_g, hi_g) in enumerate(uniq):
        dz, dy, dx = _sphere_offsets(int(rs_g), lo_g, hi_g, device)
        if len(dz) == 0:
            continue
        members = np.flatnonzero(group == g)
        step = max(1, PAIRS_PER_CHUNK // len(dz))
        for c0 in range(0, len(members), step):
            idx = members[c0:c0 + step]
            c = torch.as_tensor(cxyz[idx], device=device)
            z = c[:, 2:3] + dz[None]
            y = c[:, 1:2] + dy[None]
            x = c[:, 0:1] + dx[None]
            ok = ((z >= 0) & (z < nz) & (y >= 0) & (y < ny)
                  & (x >= 0) & (x < nx))
            flat = torch.where(ok, (z * ny + y) * nx + x, 0)
            if valid is not None:
                ok &= valid[flat]
            if foreground_normalize:
                counts[idx] = ok.sum(1).cpu().numpy()
            sid = torch.as_tensor(idx, dtype=idt,
                                  device=device)[:, None].expand_as(flat)
            owner.scatter_reduce_(0, flat[ok], sid[ok], "amax")
    mult = np.ones(n)
    if foreground_normalize:
        mult = np.where(counts > 0, 1.0 / np.maximum(counts, 1), 1.0)
    value = torch.as_tensor((foreground * mult).astype(np.float32),
                            device=device)
    hit = owner >= 0
    flat_dest = dest.reshape(-1)
    flat_dest[hit] = value[owner[hit].long()]
    return dest
