"""VoxelGrid: the device-side array model.

Port of ``visfd_tpu/core/grid.py``.  The reference holds voxel data as
host ``float***`` arrays (``mrc_simple.hpp:56-58``); here a grid is a
(Z, Y, X) float32 tensor on the card, or a ``ShardedVolume`` split over
a device mesh (``visfd_tpu_torch.parallel.mesh``), plus the physical
voxel width and an optional mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from visfd_tpu_torch.parallel.gather import to_host_np
from visfd_tpu_torch.parallel.mesh import Mesh, ShardedVolume, shard


@dataclasses.dataclass
class VoxelGrid:
    """A 3-D voxel image on a device.

    Attributes:
      data: (Z, Y, X) float32 tensor, or a ShardedVolume of its blocks.
      voxel_width: physical width of one voxel, per axis (x, y, z).
        1.0 means "work in voxel units".
      mask: optional (Z, Y, X) float32 tensor (or ShardedVolume, split as
        ``data``); 0 = ignore this voxel.  Non-binary values act as
        averaging weights, matching the reference's mask semantics
        (``filter1d.hpp:246-258``).
    """

    data: Union[torch.Tensor, ShardedVolume]
    voxel_width: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    mask: Optional[Union[torch.Tensor, ShardedVolume]] = None

    @classmethod
    def from_numpy(
        cls,
        data: np.ndarray,
        voxel_width=(1.0, 1.0, 1.0),
        mask: Optional[np.ndarray] = None,
        device=None,
        mesh: Optional[Mesh] = None,
    ) -> "VoxelGrid":
        """A grid of host arrays, as float32 on ``device`` (default: the
        card) or, with a ``mesh``, split into its (z, y) blocks on the
        mesh's devices (``parallel.mesh.shard``, the counterpart of JAX's
        ``sharding``)."""
        if np.isscalar(voxel_width):
            voxel_width = (float(voxel_width),) * 3
        dev = torch.device(device if device is not None else "cuda")

        def put(a):
            a = np.asarray(a, dtype=np.float32)
            if mesh is not None:
                return shard(a, mesh)
            return torch.tensor(a, dtype=torch.float32, device=dev)
        return cls(data=put(data), voxel_width=tuple(voxel_width),
                   mask=None if mask is None else put(mask))

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.data.shape)

    def to_numpy(self) -> np.ndarray:
        """The data as one host array (a collective over a mesh that
        spans ranks: ``parallel.gather.to_host_np``)."""
        return to_host_np(self.data)
