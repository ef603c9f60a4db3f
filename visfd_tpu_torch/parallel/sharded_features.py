"""Mesh-sharded blob ladder, plateau extrema and device watershed.

Port of ``visfd_tpu/parallel/sharded_features.py`` for one process: the volume is a ``ShardedVolume`` of (z, y) blocks
(``parallel.mesh``), and each block runs the single-device step on its
own device, reading its neighbours through a 1-voxel halo
(``parallel.halo.halo1``).  Flat indices are global, in the
single-device raster order, so no re-encoding pass is needed, and every
result equals the single-device one:

* ``find_extrema_sharded``: ``segment.extrema.find_extrema`` on the
  blocks: the neighbour flags per block, the singleton extrema and the
  (rare) plateau voxels compacted per block and merged in raster order
  on the host; plateau-heavy inputs run the min-label propagation over
  the blocks (halo exchange each round, block-local pointer jumps, the
  "changed" flag the OR over the blocks);
* ``sharded_minimax`` and ``propagate_watershed_sharded``: the
  blockwise loops of ``segment.propagate`` over the mesh;
* ``sharded_blob_dog``: ``features.blob.blob_dog`` on the blocks: each
  scale's LoG by ``parallel.sharded.separable_conv3d_sharded`` (the
  JAX package's ``make_sharded_log_fn``), the 80-neighbour test
  through 1-voxel halos (its ``_build_sharded_extremum``), the
  candidates compacted per block and merged into raster order.

A volume that the mesh does not divide is not padded (the JAX package
pads it): the CLI runs it on one device, with the same output.
"""

from __future__ import annotations

import numpy as np
import torch

from visfd_tpu_torch.features import blob as B
from visfd_tpu_torch.parallel.gather import to_host_np
from visfd_tpu_torch.parallel.mesh import Mesh, ShardedVolume, place, shard
from visfd_tpu_torch.segment import extrema as E
from visfd_tpu_torch.segment import propagate as P


def _sharded(a, mesh: Mesh):
    if a is None or isinstance(a, ShardedVolume):
        return a
    if isinstance(a, torch.Tensor):
        return shard(a, mesh)
    return shard(np.asarray(a, np.float32), mesh)


def find_extrema_sharded(x, mesh: Mesh, mask=None, connectivity: int = 3,
                         **kw) -> E.ExtremaResult:
    """``segment.extrema.find_extrema`` of a volume split over ``mesh``
    (``x`` and ``mask``: ShardedVolumes, or host arrays to split): the
    same lists, in the same order."""
    return E.find_extrema(_sharded(x, mesh), mask=_sharded(mask, mesh),
                          connectivity=connectivity, **kw)


def sharded_minimax(x_np, seeds_np, mask_np, offs, mesh: Mesh):
    """``segment.propagate._minimax_device`` of host arrays over
    ``mesh``: returns (r, labels) as host arrays, equal to the
    single-device propagation."""
    xs = _sharded(x_np, mesh)
    seeds = place(np.asarray(seeds_np, np.int32), xs)
    r, lab = P._minimax_device(xs, seeds, _sharded(mask_np, mesh), offs)
    return to_host_np(r), to_host_np(lab)


def propagate_watershed_sharded(
    source,
    mesh: Mesh,
    mask=None,
    markers=None,
    start_from_minima: bool = True,
    halt_threshold: float = np.inf,
    connectivity: int = 1,
    show_boundaries: bool = False,
    label_boundary: int = 0,
    label_undefined: int = -1,
    report=None,
) -> P.PropagateResult:
    """``segment.propagate.propagate_watershed`` over the blocks of
    ``mesh``: the descent, plateau and minimax loops exchange 1-voxel
    halos each round; the labels (a ShardedVolume) equal the
    single-device labels."""
    return P.propagate_watershed(
        _sharded(source, mesh), mask=_sharded(mask, mesh), markers=markers,
        start_from_minima=start_from_minima, halt_threshold=halt_threshold,
        connectivity=connectivity, show_boundaries=show_boundaries,
        label_boundary=label_boundary, label_undefined=label_undefined,
        report=report)


def sharded_blob_dog(x, sigmas, mesh: Mesh, mask=None, **kw):
    """``features.blob.blob_dog`` of a volume split over ``mesh`` (``x``
    and ``mask``: ShardedVolumes, or host arrays or tensors to split):
    the same (minima, maxima) lists as one device, bit for bit."""
    return B.blob_dog(_sharded(x, mesh), sigmas, mask=_sharded(mask, mesh),
                      **kw)
