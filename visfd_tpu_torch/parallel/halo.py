"""Halo exchange for sharded stencils.

Port of ``visfd_tpu/parallel/halo.py``.  A stencil over a block of a
``ShardedVolume`` needs ``halo`` rows of its neighbours' data along each
split axis.  ``halo_pad`` copies those rows from the neighbouring blocks
(``Tensor.to`` onto the block's device: a copy between cards, or a
slice when both blocks share a card) and zero-fills beyond the global
faces, so a zero-padded stencil over the haloed block gives the
single-device stencil exactly (``filter1d.hpp:93-99``).  The copies run
outside the kernels.
"""

from __future__ import annotations

import torch

from visfd_tpu_torch.parallel.mesh import ShardedVolume


def halo_pad(vol: ShardedVolume, halo: int, axis: int) -> ShardedVolume:
    """``vol`` with every block extended by ``halo`` rows on both sides
    of mesh axis ``axis`` (0: z, 1: y), filled from its neighbours along
    that axis and with zeros beyond the global volume.

    A halo deeper than a block gathers from neighbours up to
    ceil(halo / block) blocks away: each nearer neighbour gives its
    whole block, the farthest the remaining rows."""
    if halo == 0:
        return vol
    t = vol.lead + axis                 # the tensor axis being extended
    n = vol.mesh.shape[axis]
    bs = vol.block_shape[axis]
    hops = -(-halo // bs)

    def take(d):
        return bs if d < hops else halo - (hops - 1) * bs

    def slab(i_other, j, start, rows, like):
        """``rows`` rows from ``start`` of block j along the axis (zeros
        outside the grid), on the device of ``like``."""
        if not 0 <= j < n:
            shape = list(like.shape)
            shape[t] = rows
            return like.new_zeros(shape)
        src = (vol.blocks[j][i_other] if axis == 0
               else vol.blocks[i_other][j])
        return src.narrow(t, start, rows).to(like.device, non_blocking=True)

    blocks = []
    for iz, row in enumerate(vol.blocks):
        new_row = []
        for iy, b in enumerate(row):
            i, i_other = (iz, iy) if axis == 0 else (iy, iz)
            # farthest first below the block, nearest first above it
            below = [slab(i_other, i - d, bs - take(d), take(d), b)
                     for d in range(hops, 0, -1)]
            above = [slab(i_other, i + d, 0, take(d), b)
                     for d in range(1, hops + 1)]
            new_row.append(torch.cat(below + [b] + above, dim=t))
        blocks.append(tuple(new_row))
    h = list(vol.halo)
    h[axis] += halo
    return ShardedVolume(tuple(blocks), vol.mesh, vol.shape, tuple(h))


def halo_pad_2d(vol: ShardedVolume, halo_z: int,
                halo_y: int) -> ShardedVolume:
    """Halo both split axes.  The corners come out right because the y
    exchange runs after the z exchange: its rows already carry the z
    halos."""
    return halo_pad(halo_pad(vol, halo_z, 0), halo_y, 1)
