"""A seeded synthetic tomogram with dark membranes, for end-to-end
checks of the ``-membrane`` path where no recorded tomogram is at hand.

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
