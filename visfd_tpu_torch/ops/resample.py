"""Binning (box-average downsample) and unbinning (nearest-neighbour
upsample) of voxel grids.

Port of ``visfd_tpu/ops/resample.py`` (``BinArray3D`` /
``UnbinArray3D``, ``resample.hpp:53-166``): bin averages each
bin_size^3 block (remainder voxels past dest*bin are cropped; an
optional window offset shifts the block origin), unbin replicates each
voxel bin_size times (clamped at edges when sizes do not divide).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def bin_array3d(
    x: torch.Tensor,
    dest_shape_zyx: Tuple[int, int, int],
    offset_xyz: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Box-average downsample to ``dest_shape_zyx``."""
    nz, ny, nx = x.shape
    dz, dy, dx = dest_shape_zyx
    bz, by, bx = nz // dz, ny // dy, nx // dx
    oz = oy = ox = 0
    if offset_xyz is not None:
        ox, oy, oz = (int(o) for o in offset_xyz)
        for o, b in zip((ox, oy, oz), (bx, by, bz)):
            if not (0 <= o < b):
                raise ValueError("bin offset must lie in [0, bin_size)")
    v = x[oz:oz + dz * bz, oy:oy + dy * by, ox:ox + dx * bx]
    v = v.reshape(dz, bz, dy, by, dx, bx)
    return v.mean(dim=(1, 3, 5))


def unbin_array3d(
    x: torch.Tensor,
    dest_shape_zyx: Tuple[int, int, int],
    offset_xyz: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Nearest-neighbour upsample to ``dest_shape_zyx``:
    dest[I] = src[clamp((I-offset)//bin)]."""
    sz, sy, sx = x.shape
    dz, dy, dx = dest_shape_zyx
    bz, by, bx = dz // sz, dy // sy, dx // sx
    oz = oy = ox = 0
    if offset_xyz is not None:
        ox, oy, oz = (int(o) for o in offset_xyz)

    def src_idx(n_dest, off, b, n_src):
        i = np.clip((np.arange(n_dest) - off) // b, 0, n_src - 1)
        return torch.as_tensor(i, device=x.device)

    iz = src_idx(dz, oz, bz, sz)
    iy = src_idx(dy, oy, by, sy)
    ix = src_idx(dx, ox, bx, sx)
    return x[iz[:, None, None], iy[None, :, None], ix[None, None, :]]
