"""Halo exchange for sharded stencils.

Port of ``visfd_tpu/parallel/halo.py``.  A stencil over a block of a
``ShardedVolume`` needs ``halo`` rows of its neighbours' data along each
split axis.  ``halo_pad_2d`` gathers those rows from the neighbouring
blocks (``Tensor.to`` onto the block's device: a copy between cards, or a
slice when both blocks share a card) and zero-fills beyond the global
faces, so a zero-padded stencil over the haloed block gives the
single-device stencil exactly (``filter1d.hpp:93-99``).  The copies run
outside the kernels.  ``face_halos`` gives a kernel that reads its block
in place the 1-deep halos alone, as four face-sized slabs.

A neighbour on another rank (``parallel.distributed``) cannot be sliced:
``with_ghosts`` receives, for every local block, the rows of other
ranks' blocks within (hz, hy) of it, and sends its own to the ranks
that need them, all in one exchange that every rank makes.  The reads
below then take a local block's rows in place and a remote block's from
what was received, so every block sees the same bytes on any layout.
A stage exchanges once per halo depth it needs; one process exchanges
nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from visfd_tpu_torch.parallel import distributed as D
from visfd_tpu_torch.parallel.mesh import ShardedVolume


def _reach(i: int, h: int, bs: int, n: int):
    """The block indices along an axis whose rows lie within ``h`` of
    block ``i`` (blocks of ``bs`` rows, ``n`` blocks)."""
    return range(max(0, (i * bs - h) // bs), min(n, -(-((i + 1) * bs + h)
                                                      // bs)))


def with_ghosts(vol: ShardedVolume, hz: int, hy: int) -> ShardedVolume:
    """``vol`` with ``ghosts``: for each of its blocks, the planes and
    rows of other ranks' blocks within ``hz`` planes and ``hy`` rows,
    received; this rank's rows sent to the ranks whose blocks need them.
    Every rank calls it.  A volume whose blocks are all local comes back
    as it is."""
    mesh = vol.mesh
    if not mesh.spans_processes or (hz, hy) == (0, 0):
        return vol
    if vol.halo != (0, 0):
        raise ValueError("with_ghosts: the volume already carries halos")
    (nz_m, ny_m), (bz, by) = mesh.shape, vol.block_shape
    tmpl = vol.local_block
    pre = (slice(None),) * vol.lead
    sends, recvs, ghosts, planned = [], [], {}, set()
    for iz, iy in mesh.all_cells():
        dst = mesh.owner(iz, iy)
        for jz in _reach(iz, hz, bz, nz_m):
            for jy in _reach(iy, hy, by, ny_m):
                src = mesh.owner(jz, jy)
                z0 = max(iz * bz - hz, jz * bz) - jz * bz
                z1 = min((iz + 1) * bz + hz, (jz + 1) * bz) - jz * bz
                y0 = max(iy * by - hy, jy * by) - jy * by
                y1 = min((iy + 1) * by + hy, (jy + 1) * by) - jy * by
                key = (dst, jz, jy, z0, z1, y0, y1)
                if src == dst or key in planned:
                    continue
                planned.add(key)
                if src == mesh.rank:
                    sends.append((vol.blocks[jz][jy][
                        pre + (slice(z0, z1), slice(y0, y1))], dst))
                elif dst == mesh.rank:
                    buf = torch.empty(
                        tuple(tmpl.shape[:vol.lead]) + (z1 - z0, y1 - y0,
                                                        tmpl.shape[-1]),
                        dtype=tmpl.dtype, device=vol.blocks[iz][iy].device)
                    recvs.append((buf, src))
                    ghosts.setdefault((jz, jy), []).append(
                        (z0, z1, y0, y1, buf))
    D.exchange(sends, recvs)
    return dataclasses.replace(vol, ghosts=ghosts)


def _rows(vol: ShardedVolume, jz: int, jy: int, z0: int, z1: int, y0: int,
          y1: int) -> torch.Tensor:
    """Planes [z0, z1) and rows [y0, y1) (block-local, all channels and
    X) of block (jz, jy): a view of a local block, or of rows received
    by ``with_ghosts`` for another rank's."""
    t = vol.lead
    b = vol.blocks[jz][jy]
    if b is not None:
        return b.narrow(t, z0, z1 - z0).narrow(t + 1, y0, y1 - y0)
    for g0, g1, h0, h1, g in (vol.ghosts or {}).get((jz, jy), ()):
        if g0 <= z0 and z1 <= g1 and h0 <= y0 and y1 <= h1:
            return g.narrow(t, z0 - g0, z1 - z0).narrow(t + 1, y0 - h0,
                                                        y1 - y0)
    raise RuntimeError(
        f"block ({jz}, {jy}) belongs to process {vol.mesh.owner(jz, jy)}: "
        f"exchange its planes {z0}-{z1} and rows {y0}-{y1} first "
        f"(parallel.halo.with_ghosts)")


def halo_pad(vol: ShardedVolume, halo: int, axis: int) -> ShardedVolume:
    """``vol`` with every block extended by ``halo`` rows on both sides
    of mesh axis ``axis`` (0: z, 1: y), filled from its neighbours along
    that axis and with zeros beyond the global volume; a halo deeper
    than a block reaches as many blocks away as it needs."""
    if halo == 0:
        return vol
    return halo_pad_2d(vol, halo, 0) if axis == 0 else halo_pad_2d(vol, 0,
                                                                   halo)


def halo_pad_2d(vol: ShardedVolume, halo_z: int,
                halo_y: int) -> ShardedVolume:
    """Halo both split axes of a plain volume (any leading channel
    axes): each block becomes the window of the global volume around it,
    corners included (``window``)."""
    if (halo_z, halo_y) == (0, 0):
        return vol
    vol = with_ghosts(vol, halo_z, halo_y)
    bz, by = vol.block_shape
    blocks = tuple(tuple(
        None if b is None else window(
            vol, iz * bz - halo_z, (iz + 1) * bz + halo_z,
            iy * by - halo_y, (iy + 1) * by + halo_y, 0, b.device)
        for iy, b in enumerate(row)) for iz, row in enumerate(vol.blocks))
    return ShardedVolume(blocks, vol.mesh, vol.shape, (halo_z, halo_y))


def haloed_block(vol: ShardedVolume, iz: int, iy: int, halo: int,
                 fill=0, halo_y=None) -> torch.Tensor:
    """Block (iz, iy) of a plain (Z, Y, X) volume with ``halo`` rows of
    its neighbours on each side along z (``halo_y``, default ``halo``,
    along y; from as many blocks away as the halo reaches) and ``fill``
    beyond the volume: one new tensor on the block's device, built block
    by block so a stage that walks the blocks holds one haloed copy at a
    time.  Across ranks, ``vol`` comes from ``with_ghosts`` with at
    least these depths."""
    bz, by = vol.block_shape
    hy = halo if halo_y is None else halo_y
    return window(vol, iz * bz - halo, (iz + 1) * bz + halo,
                  iy * by - hy, (iy + 1) * by + hy, fill,
                  vol.blocks[iz][iy].device)


def window(vol: ShardedVolume, z_lo: int, z_hi: int, y_lo: int, y_hi: int,
           fill, device) -> torch.Tensor:
    """Planes [z_lo, z_hi) and rows [y_lo, y_hi) (global; any of them may
    lie beyond the volume, which gives ``fill``), all of X and of the
    leading channels, of a plain volume, gathered from its blocks (or
    what ``with_ghosts`` received of other ranks') onto ``device``."""
    bz, by = vol.block_shape
    nz_m, ny_m = vol.mesh.shape
    b = vol.local_block
    pre = (slice(None),) * vol.lead
    out = torch.full(tuple(b.shape[:vol.lead]) + (z_hi - z_lo, y_hi - y_lo,
                                                  b.shape[-1]), fill,
                     dtype=b.dtype, device=device)
    for jz in range(max(0, z_lo // bz), min(nz_m, -(-z_hi // bz))):
        gz0, gz1 = max(jz * bz, z_lo), min(jz * bz + bz, z_hi)
        for jy in range(max(0, y_lo // by), min(ny_m, -(-y_hi // by))):
            gy0, gy1 = max(jy * by, y_lo), min(jy * by + by, y_hi)
            src = _rows(vol, jz, jy, gz0 - jz * bz, gz1 - jz * bz,
                        gy0 - jy * by, gy1 - jy * by)
            out[pre + (slice(gz0 - z_lo, gz1 - z_lo),
                       slice(gy0 - y_lo, gy1 - y_lo))] = src.to(
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
    from another device ``Tensor.to`` copies just those, and from
    another rank they come from ``with_ghosts(vol, 1, 1)``.  Nothing of
    the block's size is copied."""
    nz_m, ny_m = vol.mesh.shape
    b = vol.blocks[iz][iy]
    bz, by, nx = b.shape

    def take(jz, jy, z0, z1, y0, y1):
        if 0 <= jz < nz_m and 0 <= jy < ny_m:
            return _rows(vol, jz, jy, z0, z1, y0, y1).to(b.device,
                                                         non_blocking=True)
        return b.new_zeros((z1 - z0, y1 - y0, nx))

    def z_plane(jz, z):
        """Plane ``z`` of the blocks in row ``jz``, rows -1 .. by."""
        return torch.cat([take(jz, iy - 1, z, z + 1, by - 1, by)[0],
                          take(jz, iy, z, z + 1, 0, by)[0],
                          take(jz, iy + 1, z, z + 1, 0, 1)[0]])

    return (z_plane(iz - 1, bz - 1), z_plane(iz + 1, 0),
            take(iz, iy - 1, 0, bz, by - 1, by)[:, 0],
            take(iz, iy + 1, 0, bz, 0, 1)[:, 0])
