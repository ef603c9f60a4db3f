"""Region painting for ``-mask-rect`` and ``-mask-sphere``.

A copy of ``draw_regions``, ``Rect`` and ``Sphere`` from
``visfd_tpu/ops/draw.py`` (``draw.hpp:88-224``): rect and sphere
primitives painted in order into a host mask; negative values subtract
voxels from the mask set (with the all-ones initialisation special
case).  Host numpy: a few primitives painted once, before the volume
goes to the card.  ``draw_spheres`` comes with the blob handlers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


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
