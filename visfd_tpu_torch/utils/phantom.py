"""Seeded synthetic tomograms for end-to-end checks where no recorded
tomogram is at hand: dark membranes for the ``-membrane`` path
(``membrane_phantom``) and dark particles for ``-blob``
(``blob_phantom``).

The volume is Gaussian noise plus dark membranes of a given thickness:
a few spherical vesicle shells and two gently curved sheets, each with
a smooth profile ``-exp(-(d / (thickness / 2))^2)`` in the distance d
to its mid-surface.  ``membrane_phantom`` also returns d to the nearest
mid-surface, so a check can ask how close detected voxels lie to a
membrane.  Built with PyTorch on the given device; the geometry comes
from a numpy generator, the noise from a torch generator on the device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def membrane_phantom(shape_zyx: Tuple[int, int, int], seed: int = 0,
                     thickness: float = 3.0, noise: float = 0.3,
                     n_vesicles: int = 4, device="cpu"):
    """(volume, distance) as (Z, Y, X) float32 tensors on ``device``."""
    nz, ny, nx = shape_zyx
    rng = np.random.default_rng(seed)
    z = torch.arange(nz, dtype=torch.float32, device=device)[:, None, None]
    y = torch.arange(ny, dtype=torch.float32, device=device)[None, :, None]
    x = torch.arange(nx, dtype=torch.float32, device=device)[None, None, :]
    dist = torch.full(shape_zyx, float("inf"), device=device)
    # two sheets z = z0 + a sin(2 pi x / lx) cos(2 pi y / ly)
    for frac in (0.3, 0.75):
        a = 0.06 * nz
        surf = frac * nz + a * torch.sin(2 * math.pi * x / nx) * \
            torch.cos(2 * math.pi * y / ny)
        dist = torch.minimum(dist, (z - surf).abs())
    # vesicle shells kept off the sheets' mean planes
    lo = np.array([0.2, 0.2, 0.2]) * shape_zyx
    for _ in range(n_vesicles):
        r = rng.uniform(0.12, 0.22) * min(shape_zyx)
        c = rng.uniform(lo + r * 0.5, np.array(shape_zyx) - lo - r * 0.5)
        d = torch.sqrt((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
        dist = torch.minimum(dist, (d - r).abs())
    vol = -torch.exp(-(dist / (0.5 * thickness)) ** 2)
    gen = torch.Generator(device=device).manual_seed(seed)
    vol = vol + noise * torch.randn(shape_zyx, generator=gen, device=device)
    return vol.to(torch.float32), dist


def blob_phantom(shape_zyx: Tuple[int, int, int], seed: int = 0,
                 n_blobs: int = 3000, diameters=(8.0, 14.0),
                 noise: float = 0.3, spacing: int = 32, device="cpu"):
    """(volume, mask, centres, diameters): ``n_blobs`` dark solid
    spheres (-1) of diameters drawn uniformly from ``diameters`` (voxels)
    on Gaussian noise, their centres (N, 3) in (z, y, x) on a jittered
    grid of ``spacing`` voxels (so no two touch), the volume blurred at
    sigma 1 so a sphere's edge is smooth; the mask (1 inside, 0 outside)
    is the slab that leaves out the top and bottom tenth of the planes,
    as a tomogram's reconstructed region.  Volume and mask are (Z, Y, X)
    float32 tensors on ``device``, centres and diameters numpy."""
    from visfd_tpu_torch.ops.draw import draw_spheres
    from visfd_tpu_torch.ops.filters import apply_gauss
    nz, ny, nx = shape_zyx
    rng = np.random.default_rng(seed)
    jit = spacing // 2 - int(np.ceil(diameters[1] / 2)) - 1
    sites = np.stack(np.meshgrid(*[np.arange(spacing // 2, n - spacing // 2,
                                             spacing) for n in shape_zyx],
                                 indexing="ij"), -1).reshape(-1, 3)
    pick = rng.choice(len(sites), size=min(n_blobs, len(sites)),
                      replace=False)
    centres = sites[np.sort(pick)] + rng.integers(-jit, jit + 1,
                                                  (len(pick), 3))
    diam = rng.uniform(diameters[0], diameters[1], len(pick))
    gen = torch.Generator(device=device).manual_seed(seed)
    bg = noise * torch.randn(shape_zyx, generator=gen, device=device)
    vol = draw_spheres(shape_zyx, centres[:, ::-1].astype(np.float64), diam,
                       np.zeros(len(pick)), -np.ones(len(pick)) + 0.0,
                       device=device)
    vol = apply_gauss(vol, 1.0, truncate_halfwidth=(3, 3, 3)) + bg
    mask = torch.zeros(shape_zyx, dtype=torch.float32, device=device)
    mask[nz // 10:nz - nz // 10] = 1.0
    return vol.to(torch.float32), mask, centres, diam
