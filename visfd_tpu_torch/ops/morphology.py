"""Grayscale morphology: dilate/erode with arbitrary structuring
elements, spherical variants with anti-aliased soft edges, opening,
closing and top-hats.

Port of ``visfd_tpu/ops/morphology.py`` (``morphology.hpp:132-590``):

* Dilation = max over the footprint of (f + b); erosion = min of
  (f - b).  Out-of-bounds, NaN and masked-out neighbours are skipped;
  where the output voxel itself is masked out the input passes through.
* Sphere structuring elements: flat (b=0, r <= radius); soft shell
  between radius and radius_max with b ramping 0 .. -bmax; or the
  8-corner anti-aliasing test when bmax != 0 and radius_max <= radius
  (``morphology.hpp:276-309``).
* Top-hats: white = src - open(src), black = close(src) - src.

Each footprint tap is a view of a haloed slab window
(``parallel.blocks.map_windows``); max/min reduce across the taps in a
fixed order, so a ``ShardedVolume`` gives the single-device values.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from visfd_tpu_torch.ops.filters import offsets_halo, window_taps
from visfd_tpu_torch.parallel.mesh import bmap

# voxels of a block per slab window
SLAB_VOXELS = 2 ** 26


def sphere_structure_element(
    radius: float,
    radius_max: float = 0.0,
    bmax: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets (K,3) as (dz,dy,dx), b-values (K,)) for the reference's
    spherical SE (``morphology.hpp:286-365``)."""
    ri = int(np.ceil(max(radius, radius_max)))
    offs, bs = [], []
    for dz in range(-ri, ri + 1):
        for dy in range(-ri, ri + 1):
            for dx in range(-ri, ri + 1):
                add, b = False, 0.0
                if bmax == 0.0:
                    if np.sqrt(dx * dx + dy * dy + dz * dz) <= radius:
                        add = True
                elif radius_max > radius:
                    r = np.sqrt(dx * dx + dy * dy + dz * dz)
                    if r <= radius:
                        add = True
                    elif r <= radius_max:
                        add = True
                        b = -bmax * (r - radius) / (radius_max - radius)
                else:
                    # 8-corner anti-aliasing test
                    corners = [
                        np.sqrt((dx + jx - 0.5) ** 2 + (dy + jy - 0.5) ** 2
                                + (dz + jz - 0.5) ** 2)
                        for jz in (0, 1) for jy in (0, 1) for jx in (0, 1)
                    ]
                    r_min, r_max = min(corners), max(corners)
                    if r_max < radius:
                        add = True
                    elif r_min > radius:
                        add = False
                    else:
                        add = True
                        b = -bmax * (r_max - radius) / (r_max - r_min)
                if add:
                    offs.append((dz, dy, dx))
                    bs.append(b)
    return np.asarray(offs, np.int32), np.asarray(bs, np.float32)


def _morph(x, offsets, bvals, mask, is_dilate: bool):
    from visfd_tpu_torch.parallel.blocks import map_windows
    offs = [tuple(int(v) for v in o) for o in np.asarray(offsets).reshape(
        -1, 3)]
    bs = [float(v) for v in np.asarray(bvals, np.float32)]
    halo = offsets_halo(offs)
    fill = -torch.inf if is_dilate else torch.inf

    def slab(inb, xw, mw):
        ok = inb if mw is None else inb & (mw != 0)
        ok = ok & ~torch.isnan(xw)
        center = next(window_taps(xw, [(0, 0, 0)], halo))
        best = torch.full_like(center, fill)
        for f, o, b in zip(window_taps(xw, offs, halo),
                           window_taps(ok, offs, halo), bs):
            if is_dilate:
                best = torch.maximum(best, torch.where(o, f + b, fill))
            else:
                best = torch.minimum(best, torch.where(o, f - b, fill))
        if mw is not None:
            best = torch.where(next(window_taps(mw, [(0, 0, 0)], halo)) != 0,
                               best, center)
        return best

    return map_windows(slab, [x, mask], [0.0, 0.0], halo,
                       slab_voxels=SLAB_VOXELS)


def dilate(x, offsets, bvals, mask=None):
    """Grayscale dilation max(f + b) over the footprint
    (``morphology.hpp:132-174``)."""
    return _morph(x, offsets, bvals, mask, True)


def erode(x, offsets, bvals, mask=None):
    """Grayscale erosion min(f - b) over the footprint
    (``morphology.hpp:183-231``)."""
    return _morph(x, offsets, bvals, mask, False)


def dilate_sphere(x, radius, mask=None, radius_max=0.0, bmax=0.0):
    o, b = sphere_structure_element(radius, radius_max, bmax)
    return dilate(x, o, b, mask)


def erode_sphere(x, radius, mask=None, radius_max=0.0, bmax=0.0):
    o, b = sphere_structure_element(radius, radius_max, bmax)
    return erode(x, o, b, mask)


def open_sphere(x, radius, mask=None, radius_max=0.0, bmax=0.0):
    """Erosion then dilation (``morphology.hpp:428-467``)."""
    return dilate_sphere(
        erode_sphere(x, radius, mask, radius_max, bmax),
        radius, mask, radius_max, bmax)


def close_sphere(x, radius, mask=None, radius_max=0.0, bmax=0.0):
    """Dilation then erosion (``morphology.hpp:472-508``)."""
    return erode_sphere(
        dilate_sphere(x, radius, mask, radius_max, bmax),
        radius, mask, radius_max, bmax)


def white_top_hat_sphere(x, radius, mask=None, radius_max=0.0, bmax=0.0):
    """src - opening (``morphology.hpp:515-549``)."""
    return bmap(torch.sub, x, open_sphere(x, radius, mask, radius_max, bmax))


def black_top_hat_sphere(x, radius, mask=None, radius_max=0.0, bmax=0.0):
    """closing - src (``morphology.hpp:554-590``)."""
    return bmap(torch.sub, close_sphere(x, radius, mask, radius_max, bmax),
                x)
