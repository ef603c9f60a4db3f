"""Watershed segmentation (the Meyer inter-pixel flood) on the host.

Port of ``visfd_tpu/segment/watershed.py`` (``Watershed``,
``segmentation.hpp:65-559``):

* seeds: the plateau minima (or maxima) of ``segment.extrema``, found on
  the source's device, or a marker image (labels > 0; the first raster
  voxel of each label seeds its basin);
* the priority flood pops the lowest queued voxel (ties as the
  reference's ``priority_queue<tuple<-score, basin, (ix,iy,iz)>>``: the
  larger basin id, then the larger (ix, iy, iz)), gives it the queuing
  basin and queues its unvisited in-mask neighbours; a popped voxel that
  touches another basin becomes the boundary label;
* voxels beyond ``halt_threshold`` (after the minima/maxima sign flip)
  become ``label_undefined``;
* with markers, basin ids map back to the marker labels through a table
  over the basin ids.

The flood is sequential by nature and runs in the native C++ core
(``native/``); there is no fallback: a missing compiler raises.
``_flood_python`` is its plain twin, which the tests hold it against.
The device alternative is ``segment.propagate``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import heapq
from typing import Optional

import numpy as np
import torch

from visfd_tpu_torch import native
from visfd_tpu_torch.segment.extrema import (
    find_extrema, flat_to_xyz, neighbor_offsets)
from visfd_tpu_torch.utils.progress import Report, stage
from visfd_tpu_torch.utils.transfer import to_device, to_host

WATERSHED_BOUNDARY = 0
UNDEFINED = -1


@dataclasses.dataclass
class WatershedResult:
    labels: np.ndarray           # (Z, Y, X) int64; basins are 1..N
    num_basins: int
    basin_locations: np.ndarray  # (N, 3) as (ix, iy, iz)
    basin_scores: np.ndarray


def watershed(
    source,
    mask=None,
    markers: Optional[np.ndarray] = None,
    halt_threshold: float = np.inf,
    start_from_minima: bool = True,
    connectivity: int = 1,
    show_boundaries: bool = True,
    label_boundary: int = WATERSHED_BOUNDARY,
    label_undefined: int = UNDEFINED,
    report: Optional[Report] = None,
) -> WatershedResult:
    """``source`` (and ``mask``): a tensor, whose seeds are found on its
    device, or a numpy array (on the CPU).  ``markers``: a host array.
    ``report`` collects the spans of the seeds and the flood, and counts
    the copies of the source and the mask."""
    rep = report if report is not None else Report(None)
    src = torch.as_tensor(source, dtype=torch.float32)
    src_np = np.ascontiguousarray(to_host(src, rep))
    nz, ny, nx = src_np.shape
    valid = None if mask is None else to_host(mask, rep) != 0
    offs = neighbor_offsets(connectivity)

    sign = 1.0 if start_from_minima else -1.0
    if (not start_from_minima) and np.isinf(halt_threshold) \
       and halt_threshold > 0:
        halt_threshold = -np.inf

    marker_labels = None
    if markers is not None:
        # the first voxel of each label in raster order (the reference's
        # sequential discovery)
        flat = np.asarray(markers).reshape(-1)
        ok = flat > 0
        if valid is not None:
            ok &= valid.reshape(-1)
        hit = np.flatnonzero(ok)
        uniq, first = np.unique(flat[hit], return_index=True)
        disc = np.argsort(first, kind="stable")
        seed_flat = hit[first[disc]]
        marker_labels = uniq[disc].astype(np.int64)
        seed_scores = src_np.reshape(-1)[seed_flat].astype(np.float32)
    else:
        with stage("watershed: seeds", rep):
            res = find_extrema(
                src, mask=None if mask is None else to_device(
                    mask, src.device, rep),
                find_minima=start_from_minima,
                find_maxima=not start_from_minima,
                minima_threshold=(halt_threshold if start_from_minima
                                  else np.inf),
                maxima_threshold=(halt_threshold if not start_from_minima
                                  else -np.inf),
                connectivity=connectivity, allow_borders=True,
                want_label_image=False)
        seed_flat = (res.minima_indices if start_from_minima
                     else res.maxima_indices)
        seed_scores = np.asarray(res.minima_scores if start_from_minima
                                 else res.maxima_scores, np.float32)
    seed_locs = np.stack(flat_to_xyz(np.asarray(seed_flat, np.int64),
                                     src_np.shape), -1).reshape(-1, 3)
    num_basins = len(seed_locs)

    valid_c = None if valid is None else np.ascontiguousarray(valid, np.uint8)
    seeds_c = np.ascontiguousarray(seed_locs, np.int32)
    scores_c = np.ascontiguousarray(seed_scores, np.float32)
    offs_c = np.ascontiguousarray(np.asarray(offs, np.int32))
    labels = np.empty(src_np.shape, np.int64)
    lib = native.load()
    with stage("watershed: native flood", rep):
        lib.visfd_watershed_flood(
            native.ptr(src_np, ctypes.c_float),
            native.ptr(valid_c, ctypes.c_uint8),
            nz, ny, nx,
            native.ptr(seeds_c, ctypes.c_int32),
            native.ptr(scores_c, ctypes.c_float), num_basins,
            native.ptr(offs_c, ctypes.c_int32), len(offs),
            float(sign), float(halt_threshold), int(show_boundaries),
            native.ptr(labels, ctypes.c_int64))

    if label_boundary != WATERSHED_BOUNDARY:
        labels[labels == WATERSHED_BOUNDARY] = label_boundary
    if label_undefined != UNDEFINED:
        sel = labels == UNDEFINED
        if valid is not None:
            sel &= valid
        labels[sel] = label_undefined

    if marker_labels is not None:
        # basin ids -> marker labels; the boundary, undefined and
        # out-of-mask voxels keep their value
        basin_sel = (labels != label_boundary) & (labels != label_undefined)
        if valid is not None:
            basin_sel &= valid
        lut = np.full(num_basins + 1, label_undefined, np.int64)
        lut[1:] = marker_labels
        vals = labels[basin_sel]
        labels[basin_sel] = np.where((vals >= 1) & (vals <= num_basins),
                                     lut[np.clip(vals, 0, num_basins)],
                                     label_undefined)

    return WatershedResult(
        labels=labels, num_basins=num_basins,
        basin_locations=seed_locs.astype(np.int64),
        basin_scores=np.asarray(seed_scores, np.float32))


def _flood_python(source, valid, basin_locs, basin_scores, num_basins,
                  offs, sign, halt_threshold, show_boundaries):
    """Pure-Python Meyer flood, the plain twin of the native core."""
    nz, ny, nx = source.shape
    labels = np.full(source.shape, UNDEFINED, np.int64)
    QUEUED = num_basins + 2  # internal sentinel distinct from all labels

    # heapq is a min-heap; the reference's max-heap of (-score, basin,
    # coords) pops min score, then max basin, then max coords
    q = []
    for i, (ix, iy, iz) in enumerate(basin_locs):
        heapq.heappush(q, (basin_scores[i] * sign, -i, (-ix, -iy, -iz)))
        labels[iz, iy, ix] = QUEUED

    while q:
        score, neg_basin, neg_crd = heapq.heappop(q)
        basin = -neg_basin
        ix, iy, iz = -neg_crd[0], -neg_crd[1], -neg_crd[2]
        if score > halt_threshold * sign:
            labels[iz, iy, ix] = UNDEFINED
            continue
        if valid is not None and not valid[iz, iy, ix]:
            labels[iz, iy, ix] = UNDEFINED
            continue
        labels[iz, iy, ix] = basin + 1
        for dz, dy, dx in offs:
            z, y, x = iz + dz, iy + dy, ix + dx
            if not (0 <= z < nz and 0 <= y < ny and 0 <= x < nx):
                continue
            if valid is not None and not valid[z, y, x]:
                continue
            nlab = labels[z, y, x]
            if nlab == WATERSHED_BOUNDARY or nlab == QUEUED:
                continue
            if nlab == UNDEFINED:
                labels[z, y, x] = QUEUED
                heapq.heappush(q, (float(source[z, y, x]) * sign, -basin,
                                   (-x, -y, -z)))
            elif nlab != labels[iz, iy, ix] and show_boundaries:
                # the popped voxel is the shallower one -> boundary
                labels[iz, iy, ix] = WATERSHED_BOUNDARY
    return labels
