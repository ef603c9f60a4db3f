"""The one generator of the benchmark's traffic: seeded synthetic
tomograms made on the device from a traffic file's parameters.

A plain PyTorch copy of ``visfd_tpu_torch/utils/phantom.py`` (the same
numbers for the same seed and device): ``membrane`` is Gaussian noise
plus dark membranes (two gently curved sheets and spherical vesicle
shells) with the profile -exp(-(d / (thickness / 2))^2) in the distance
d to the mid-surface; ``blob`` is dark solid spheres (-1) on a jittered
grid, blurred at sigma 1, plus noise, with the slab mask that leaves out
the top and bottom tenth of the planes.  The geometry comes from a
numpy generator, the noise from a ``torch.Generator`` on the device.

Any other kind is a file of its own, ``traffic/kinds/<kind>.py``, found
by name: a later traffic adds a kind by adding that file."""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from portbench.harness import manifest, plain


def _seed64(seed: int) -> int:
    return int(seed) % 2 ** 63


def membrane(shape_zyx: Tuple[int, int, int], seed: int,
             thickness: float, noise: float, n_vesicles: int, device):
    """(volume, distance to the nearest mid-surface), float32 (Z, Y, X)."""
    nz, ny, nx = shape_zyx
    rng = np.random.default_rng(_seed64(seed))
    z = torch.arange(nz, dtype=torch.float32, device=device)[:, None, None]
    y = torch.arange(ny, dtype=torch.float32, device=device)[None, :, None]
    x = torch.arange(nx, dtype=torch.float32, device=device)[None, None, :]
    dist = torch.full(shape_zyx, float("inf"), device=device)
    for frac in (0.3, 0.75):
        a = 0.06 * nz
        surf = frac * nz + a * torch.sin(2 * math.pi * x / nx) * \
            torch.cos(2 * math.pi * y / ny)
        dist = torch.minimum(dist, (z - surf).abs())
    lo = np.array([0.2, 0.2, 0.2]) * shape_zyx
    for _ in range(n_vesicles):
        r = rng.uniform(0.12, 0.22) * min(shape_zyx)
        c = rng.uniform(lo + r * 0.5, np.array(shape_zyx) - lo - r * 0.5)
        d = torch.sqrt((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
        dist = torch.minimum(dist, (d - r).abs())
    vol = -torch.exp(-(dist / (0.5 * thickness)) ** 2)
    gen = torch.Generator(device=device).manual_seed(_seed64(seed))
    vol = vol + noise * torch.randn(shape_zyx, generator=gen, device=device)
    return vol.to(torch.float32), dist


def _spheres(shape_zyx, centres_zyx: np.ndarray, diameters: np.ndarray,
             device) -> torch.Tensor:
    """-1 on the voxels c + j, |j_i| <= ceil(d / 2 - 0.5), |j|^2 <=
    (d / 2)^2, of each sphere inside the volume; 0 elsewhere."""
    nz, ny, nx = shape_zyx
    out = torch.zeros(nz * ny * nx, dtype=torch.float32, device=device)
    if not len(diameters):
        return out.reshape(shape_zyx)
    rs = np.maximum(np.ceil(diameters / 2 - 0.5), 0).astype(np.int64)
    j = torch.arange(-int(rs.max()), int(rs.max()) + 1, device=device)
    dz, dy, dx = (t.reshape(-1) for t in torch.meshgrid(j, j, j,
                                                        indexing="ij"))
    r2 = (dz * dz + dy * dy + dx * dx).to(torch.float64)
    c = torch.as_tensor(centres_zyx, dtype=torch.int64, device=device)
    lim = torch.as_tensor(rs, device=device)[:, None]
    r2max = torch.as_tensor((diameters / 2) ** 2, device=device)[:, None]
    z, y, x = (c[:, i:i + 1] + d[None] for i, d in enumerate((dz, dy, dx)))
    ok = ((dz.abs()[None] <= lim) & (dy.abs()[None] <= lim)
          & (dx.abs()[None] <= lim) & (r2[None] <= r2max)
          & (z >= 0) & (z < nz) & (y >= 0) & (y < ny) & (x >= 0) & (x < nx))
    out[((z * ny + y) * nx + x)[ok]] = -1.0
    return out.reshape(shape_zyx)


def blob(shape_zyx: Tuple[int, int, int], seed: int, n_blobs: int,
         diameters: Tuple[float, float], noise: float, spacing: int,
         device):
    """(volume, mask, centres (N, 3) as (z, y, x), diameters (N,))."""
    nz, ny, nx = shape_zyx
    rng = np.random.default_rng(_seed64(seed))
    jit = spacing // 2 - int(np.ceil(diameters[1] / 2)) - 1
    sites = np.stack(np.meshgrid(*[np.arange(spacing // 2, n - spacing // 2,
                                             spacing) for n in shape_zyx],
                                 indexing="ij"), -1).reshape(-1, 3)
    pick = rng.choice(len(sites), size=min(n_blobs, len(sites)),
                      replace=False)
    centres = sites[np.sort(pick)] + rng.integers(-jit, jit + 1,
                                                  (len(pick), 3))
    diam = rng.uniform(diameters[0], diameters[1], len(pick))
    gen = torch.Generator(device=device).manual_seed(_seed64(seed))
    bg = noise * torch.randn(shape_zyx, generator=gen, device=device)
    vol = _spheres(shape_zyx, centres, diam, device)
    k = plain.gauss_kernel_1d(1.0, 3)
    vol = plain.blur3(vol, k) / plain.edge_denominator(
        k, shape_zyx, torch.float32, device) + bg
    mask = torch.zeros(shape_zyx, dtype=torch.float32, device=device)
    mask[nz // 10:nz - nz // 10] = 1.0
    return vol.to(torch.float32), mask, centres, diam


def make(traffic: Dict, shape_zyx, voxel_width: float, seed: int,
         device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(tomogram, mask or None) of one traffic file's ``phantom``: a
    built-in kind here, any other by ``traffic/kinds/<kind>.py``'s
    ``make(phantom, shape_zyx, voxel_width, seed, device)``."""
    p = traffic["phantom"]
    if p["kind"] == "membrane":
        vol, _ = membrane(shape_zyx, seed, p["thickness_A"] / voxel_width,
                          p["noise"], p["n_vesicles"], device)
        return vol, None
    if p["kind"] == "blob":
        lo, hi = (d / voxel_width for d in p["diameters_A"])
        vol, mask, _, _ = blob(shape_zyx, seed, p["n_blobs"], (lo, hi),
                               p["noise"], p["spacing"], device)
        return vol, mask
    path = manifest.kind_path(p["kind"])
    if not os.path.isfile(path):
        raise ValueError(f"no phantom kind {p['kind']!r} ({path})")
    kind = manifest.load_module(path, f"portbench_kind_{p['kind']}")
    return kind.make(p, shape_zyx, voxel_width, seed, device)
