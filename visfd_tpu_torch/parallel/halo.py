"""Halo exchange for sharded stencils.

Port of ``visfd_tpu/parallel/halo.py``.  A stencil over a block of a
``ShardedVolume`` needs ``halo`` rows of its neighbours' data along each
split axis.  ``halo_pad`` copies those rows from the neighbouring blocks
(``Tensor.to`` onto the block's device: a copy between cards, or a
slice when both blocks share a card) and zero-fills beyond the global
faces, so a zero-padded stencil over the haloed block gives the
single-device stencil exactly (``filter1d.hpp:93-99``).  The copies run
outside the kernels.  ``face_halos`` gives a kernel that reads its block
in place the 1-deep halos alone, as four face-sized slabs.
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


def haloed_block(vol: ShardedVolume, iz: int, iy: int, halo: int,
                 fill=0, halo_y=None) -> torch.Tensor:
    """Block (iz, iy) of a plain (Z, Y, X) volume with ``halo`` rows of
    its neighbours on each side along z (``halo_y``, default ``halo``,
    along y; from as many blocks away as the halo reaches) and ``fill``
    beyond the volume: one new tensor on the block's device, built block
    by block so a stage that walks the blocks holds one haloed copy at a
    time."""
    bz, by = vol.block_shape
    hy = halo if halo_y is None else halo_y
    return window(vol, iz * bz - halo, (iz + 1) * bz + halo,
                  iy * by - hy, (iy + 1) * by + hy, fill,
                  vol.blocks[iz][iy].device)


def window(vol: ShardedVolume, z_lo: int, z_hi: int, y_lo: int, y_hi: int,
           fill, device) -> torch.Tensor:
    """Planes [z_lo, z_hi) and rows [y_lo, y_hi) (global; any of them may
    lie beyond the volume, which gives ``fill``), all of X, of a plain
    (Z, Y, X) volume, gathered from its blocks onto ``device``."""
    bz, by = vol.block_shape
    nz_m, ny_m = vol.mesh.shape
    b = vol.blocks[0][0]
    out = torch.full((z_hi - z_lo, y_hi - y_lo, b.shape[-1]), fill,
                     dtype=b.dtype, device=device)
    for jz in range(max(0, z_lo // bz), min(nz_m, -(-z_hi // bz))):
        gz0, gz1 = max(jz * bz, z_lo), min(jz * bz + bz, z_hi)
        for jy in range(max(0, y_lo // by), min(ny_m, -(-y_hi // by))):
            gy0, gy1 = max(jy * by, y_lo), min(jy * by + by, y_hi)
            src = vol.blocks[jz][jy][gz0 - jz * bz:gz1 - jz * bz,
                                     gy0 - jy * by:gy1 - jy * by]
            out[gz0 - z_lo:gz1 - z_lo, gy0 - y_lo:gy1 - y_lo] = src.to(
                out.device, non_blocking=True)
    return out


def halo1(vol: ShardedVolume, iz: int, iy: int, fill) -> torch.Tensor:
    """Block (iz, iy) padded by one voxel on every face: its neighbours'
    rows along z and y, ``fill`` beyond the volume (x included), for
    the segmentation stencils, which read every neighbour of a voxel."""
    return torch.nn.functional.pad(haloed_block(vol, iz, iy, 1, fill),
                                   (1, 1), value=fill)


def face_halos(vol: ShardedVolume, iz: int, iy: int):
    """The 1-deep halos of block (iz, iy) of a plain (Z, Y, X) volume as
    four slabs, zeros beyond the global volume: (z_lo, z_hi), the planes
    below and above the block, (by + 2, X) with their y-corner rows
    first and last; (y_lo, y_hi), the rows before and after it, (bz,
    X).  A y halo from a block on the same device is a
    view of that block and a z halo one plane and two rows put together;
    from another device ``Tensor.to`` copies just those.  Nothing of the
    block's size is copied."""
    nz_m, ny_m = vol.mesh.shape
    b = vol.blocks[iz][iy]
    bz, by, nx = b.shape

    def take(jz, jy, index, shape):
        if 0 <= jz < nz_m and 0 <= jy < ny_m:
            return vol.blocks[jz][jy][index].to(b.device, non_blocking=True)
        return b.new_zeros(shape)

    def z_plane(jz, z):
        """Plane ``z`` of the blocks in row ``jz``, rows -1 .. by."""
        return torch.cat([take(jz, iy - 1, (z, slice(-1, None)), (1, nx)),
                          take(jz, iy, z, (by, nx)),
                          take(jz, iy + 1, (z, slice(0, 1)), (1, nx))])

    return (z_plane(iz - 1, -1), z_plane(iz + 1, 0),
            take(iz, iy - 1, (slice(None), -1), (bz, nx)),
            take(iz, iy + 1, (slice(None), 0), (bz, nx)))
