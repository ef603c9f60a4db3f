"""Blockwise fixpoint loops over (z, y) blocks, for the segmentation.

The device watershed (``segment.propagate``) and the plateau labels of
``segment.extrema`` walk the blocks of a ``parallel.mesh.ShardedVolume``
(a plain tensor is the one block of a 1 x 1 grid): each block reads its
neighbours through a 1-voxel halo (``parallel.halo.halo1``), indexes
voxels by their global flat index in the single-device raster order
(``Geom``), and a loop runs until no block changes (``fixpoint``).
Over a mesh that spans ranks the windows' halos come from
``parallel.halo.with_ghosts`` and the loop's "changed" flags are summed
over the ranks at each read, so every rank runs the same iterations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from visfd_tpu_torch.parallel import distributed as D
from visfd_tpu_torch.parallel.mesh import ShardedVolume

SENT = 2 ** 31 - 1          # int32 sentinel (the JAX package's SENT, BIG)
INF = float("inf")
SYNC_EVERY = 8              # iterations between reads of a loop's flag


def check_index_width(shape) -> None:
    n = int(np.prod(shape))
    if n >= SENT:
        raise ValueError(f"the blockwise segmentation loops index voxels "
                         f"with int32; "
                         f"{tuple(shape)} has {n} voxels, more than "
                         f"{SENT - 1}")


def nb(p, off):
    """The neighbours at ``off`` of every voxel of a block padded by one
    voxel on each face."""
    dz, dy, dx = off
    bz, by, nx = (s - 2 for s in p.shape)
    return p[1 + dz:1 + dz + bz, 1 + dy:1 + dy + by, 1 + dx:1 + dx + nx]


class Geom:
    """Global flat indices and in-volume tests of each block's voxels."""

    def __init__(self, vol: ShardedVolume):
        self.shape = tuple(vol.shape[-3:])
        self.bz, self.by = vol.block_shape
        check_index_width(self.shape)

    def coords(self, iz, iy, device):
        nz, ny, nx = self.shape
        z = torch.arange(self.bz, device=device) + iz * self.bz
        y = torch.arange(self.by, device=device) + iy * self.by
        return z, y, torch.arange(nx, device=device)

    def idx(self, iz, iy, device):
        _, ny, nx = self.shape
        z, y, x = self.coords(iz, iy, device)
        return ((z[:, None, None] * ny + y[None, :, None]) * nx
                + x[None, None, :]).to(torch.int32)

    def inb(self, iz, iy, off, device):
        """Whether the neighbour at ``off`` lies in the volume."""
        z, y, x = self.coords(iz, iy, device)
        ok = [((c + d) >= 0) & ((c + d) < n)
              for c, d, n in zip((z, y, x), off, self.shape)]
        return (ok[0][:, None, None] & ok[1][None, :, None]
                & ok[2][None, None, :])

    def delta(self, off):
        _, ny, nx = self.shape
        dz, dy, dx = off
        return (dz * ny + dy) * nx + dx

    def jump(self, iz, iy, lab, *others):
        """Block-local pointer jump: where ``lab`` (a global flat index)
        points inside this block, the values there of ``lab`` and of
        ``others``; elsewhere None (for ``others``) / ``lab`` itself."""
        _, ny, nx = self.shape
        bz, by = self.bz, self.by
        z0, y0 = iz * bz, iy * by
        dz = lab // (ny * nx)
        rem = lab - dz * (ny * nx)
        dy = rem // nx
        dx = rem - dy * nx
        inblk = (dz >= z0) & (dz < z0 + bz) & (dy >= y0) & (dy < y0 + by)
        loc = (((dz - z0) * by + (dy - y0)) * nx + dx).clamp(
            0, bz * by * nx - 1).reshape(-1)
        return inblk, [t.reshape(-1)[loc].reshape(t.shape)
                       for t in (lab,) + others]


def _spans(state) -> bool:
    """Whether a loop's state (a ShardedVolume or a tuple of them)
    spans ranks."""
    vols = state if isinstance(state, tuple) else (state,)
    return any(isinstance(v, ShardedVolume) and v.mesh.spans_processes
               for v in vols)


def fixpoint(step, state, max_it: Optional[int] = None):
    """``state = step(state)`` until an iteration changes nothing (or
    ``max_it`` iterations ran), the per-block "changed" flags read every
    SYNC_EVERY iterations (and summed over the ranks when the state spans
    them).  Returns (state, iterations the JAX loop runs): the changing
    iterations plus the one that found the fixpoint."""
    spans = _spans(state)
    it, n_changed = 0, 0
    while max_it is None or it < max_it:
        k = SYNC_EVERY if max_it is None else min(SYNC_EVERY, max_it - it)
        flags = []
        for _ in range(k):
            state, changed = step(state)
            flags.append(changed)
        it += k
        per_it = np.array([sum(bool(c) for c in ch) for ch in flags],
                          np.int64)
        if spans:
            per_it = D.allreduce_sum(per_it)
        n_changed += int((per_it > 0).sum())
        if not per_it[-1]:
            break
    n = n_changed + 1
    return state, n if max_it is None else min(n, max_it)


def cells(*vols):
    """(iz, iy, blocks...) over several volumes of one partition."""
    for iz, iy, b in vols[0].cells():
        yield (iz, iy, b) + tuple(v.blocks[iz][iy] for v in vols[1:])


def iter_windows(vols, fills, halo, slab_voxels: Optional[int] = None):
    """Walk the z slabs of the blocks of the (Z, Y, X) volumes ``vols``
    (ShardedVolumes of one partition, or tensors: the one block of a
    1 x 1 grid; None stays None).  Yields (iz, iy, z0, y0, windows):
    the slab's first global plane and row, and per volume the slab's
    planes and the block's rows with ``halo`` = (hz, hy, hx) neighbours
    on each side (from the neighbouring blocks; ``fills[i]`` beyond the
    volume, x included), led by a boolean window that is True inside
    the volume (broadcast from its three axes).  A slab holds at most
    ``slab_voxels`` voxels of its block (one plane at least)."""
    from visfd_tpu_torch.parallel.halo import window, with_ghosts
    from visfd_tpu_torch.parallel.mesh import as_blocks
    hz, hy, hx = halo
    bvs = [None if v is None else with_ghosts(as_blocks(v), hz, hy)
           for v in vols]
    v0 = bvs[0]
    bz, by = v0.block_shape
    nz, ny, nx = v0.shape[-3:]
    planes = bz if slab_voxels is None else max(
        1, min(bz, slab_voxels // max(1, by * nx)))
    for iz, iy, b in v0.cells():
        for z0 in range(0, bz, planes):
            z1 = min(bz, z0 + planes)
            gz0, gy0 = iz * bz + z0, iy * by
            zs = torch.arange(gz0 - hz, gz0 + (z1 - z0) + hz, device=b.device)
            ys = torch.arange(gy0 - hy, gy0 + by + hy, device=b.device)
            xs = torch.arange(-hx, nx + hx, device=b.device)
            wins = [((zs >= 0) & (zs < nz))[:, None, None]
                    & ((ys >= 0) & (ys < ny))[None, :, None]
                    & ((xs >= 0) & (xs < nx))[None, None, :]]
            for v, fill in zip(bvs, fills):
                if v is None:
                    wins.append(None)
                    continue
                w = window(v, gz0 - hz, gz0 + (z1 - z0) + hz, gy0 - hy,
                           gy0 + by + hy, fill, b.device)
                wins.append(torch.nn.functional.pad(w, (hx, hx), value=fill)
                            if hx else w)
            yield iz, iy, gz0, gy0, wins


def map_windows(fn, vols, fills, halo, slab_voxels: Optional[int] = None):
    """``fn(*windows)`` over each z slab of each block (``iter_windows``)
    returns the slab's output, (slab planes, block rows, X); the result
    is in the form of the first volume.  Every output voxel sees the
    same neighbours however the volume is split, so a stencil that
    computes each voxel from its own window alone gives the same bits on
    one device and on the mesh."""
    from visfd_tpu_torch.parallel.mesh import as_blocks, from_blocks, unwrap
    v0 = as_blocks(vols[0])
    parts = {}
    for iz, iy, _, _, wins in iter_windows(vols, fills, halo, slab_voxels):
        parts.setdefault((iz, iy), []).append(fn(*wins))
    nz_m, ny_m = v0.mesh.shape
    blocks = [[None if (iz, iy) not in parts
               else torch.cat(parts[iz, iy]) if len(parts[iz, iy]) > 1
               else parts[iz, iy][0] for iy in range(ny_m)]
              for iz in range(nz_m)]
    return unwrap(from_blocks(blocks, v0.mesh), vols[0])
