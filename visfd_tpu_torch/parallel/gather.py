"""Host copies of device results, and who writes files.

Port of ``visfd_tpu/parallel/gather.py``.  ``to_host_np`` copies each
block of a ``ShardedVolume`` into its place in one host array; in a
multi-process cluster it is a collective, as the JAX package's
``process_allgather(tiled=True)``: every rank receives the blocks of the
others and returns the whole array, so every rank calls it, also where
only rank 0 uses the result.  ``gather_on_device`` is its counterpart
on a device: the whole volume as one tensor there (the device watershed's
pointer jumping reads every block's parents).  File writes are gated on
``is_writer`` (rank 0), so N processes running one command write one
file.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from visfd_tpu_torch.parallel import distributed as D
from visfd_tpu_torch.parallel.mesh import ShardedVolume
from visfd_tpu_torch.utils.transfer import to_host


def to_host_np(vol, dtype=None, report=None) -> Optional[np.ndarray]:
    """A tensor, a host array or a ShardedVolume as one numpy array on
    the host (``None`` passes through), each copy through
    ``utils/transfer.to_host`` (a ShardedVolume's z slabs each into
    their place), counted in a ``Report``."""
    if vol is None:
        return None
    if not isinstance(vol, ShardedVolume):
        return to_host(vol, report, dtype)
    if vol.halo != (0, 0):
        raise ValueError("to_host_np: the volume still carries halos")
    bz, _ = vol.block_shape
    pre = (slice(None),) * vol.lead
    out = torch.empty(vol.shape, dtype=vol.local_block.dtype)
    for iz, row in enumerate(vol.blocks):
        # the z slab: the row's blocks joined along y on the device of
        # its first block, then one copy into its place on the host
        parts = _row_blocks(vol, iz)
        dev = parts[0].device
        slab = torch.cat([b.detach().to(dev, non_blocking=True)
                          for b in parts], dim=vol.lead + 1)
        to_host(slab, report, out=out[pre + (slice(iz * bz, (iz + 1) * bz),)])
    out = out.numpy()
    return out if dtype is None else out.astype(dtype, copy=False)


def gather_on_device(vol: ShardedVolume, device,
                     kind: str = "gather") -> torch.Tensor:
    """The whole volume of ``vol`` as one tensor on ``device``: each
    block copied into its place, another rank's received from it first
    (a collective in a cluster, its exchanges counted under ``kind``)."""
    bz, by = vol.block_shape
    pre = (slice(None),) * vol.lead
    out = torch.empty(vol.shape, dtype=vol.local_block.dtype, device=device)
    for iz in range(vol.mesh.shape[0]):
        for iy, b in enumerate(_row_blocks(vol, iz, kind)):
            out[pre + (slice(iz * bz, (iz + 1) * bz),
                       slice(iy * by, (iy + 1) * by))] = b.to(device)
    return out


def _row_blocks(vol: ShardedVolume, iz: int, kind: str = "gather"):
    """The blocks of row ``iz``: the local ones as they are, each other
    rank's received from it (every rank sends its blocks of the row to
    every other rank, in cell order, then rank order)."""
    mesh = vol.mesh
    row = list(vol.blocks[iz])
    if not mesh.spans_processes:
        return row
    tmpl = vol.local_block
    sends, recvs = [], []
    for iy, b in enumerate(row):
        owner = mesh.owner(iz, iy)
        if b is not None:
            sends += [(b, r) for r in range(D.process_count()) if r != owner]
        else:
            # gloo receives into host memory, NCCL on the rank's card
            row[iy] = torch.empty(tmpl.shape, dtype=tmpl.dtype,
                                  device=D.comm_device())
            recvs.append((row[iy], owner))
    D.exchange(sends, recvs, kind=kind)
    return row


def is_writer() -> bool:
    """True on the process that writes files: rank 0 (always, in one
    process)."""
    return D.process_index() == 0
