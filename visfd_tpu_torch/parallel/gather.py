"""Host copies of device results, and who writes files.

Port of ``visfd_tpu/parallel/gather.py`` for one process: every block of
a ``ShardedVolume`` is addressable here, so ``to_host_np`` copies each
block into its place in one host array, and this process is the writer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from visfd_tpu_torch.parallel.mesh import ShardedVolume


def to_host_np(vol, dtype=None) -> Optional[np.ndarray]:
    """A tensor or a ShardedVolume as one numpy array on the host
    (``None`` passes through)."""
    if vol is None:
        return None
    if not isinstance(vol, ShardedVolume):
        out = vol.detach().cpu().numpy()
        return out if dtype is None else out.astype(dtype, copy=False)
    if vol.halo != (0, 0):
        raise ValueError("to_host_np: the volume still carries halos")
    bz, _ = vol.block_shape
    pre = (slice(None),) * vol.lead
    out = torch.empty(vol.shape, dtype=vol.blocks[0][0].dtype)
    for iz, row in enumerate(vol.blocks):
        # the z slab: the row's blocks joined along y on the device of
        # its first block, then one copy into its place on the host
        dev = row[0].device
        slab = torch.cat([b.detach().to(dev, non_blocking=True)
                          for b in row], dim=vol.lead + 1)
        out[pre + (slice(iz * bz, (iz + 1) * bz),)].copy_(slab)
    out = out.numpy()
    return out if dtype is None else out.astype(dtype, copy=False)


def is_writer() -> bool:
    """True on the process that writes files: always, in one process."""
    return True
