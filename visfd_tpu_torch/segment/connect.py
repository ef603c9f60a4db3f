"""Direction-aware connected-component labelling (``-connect``).

Port of ``visfd_tpu/segment/connect.py`` (``LabelConnected``,
``connect.hpp:168-1432``): a watershed-like flood from saliency maxima
that

1. discards voxels whose saliency Hessian disagrees with the vote tensor
   (trace-product gate) or whose principal Hessian eigenvector disagrees
   with the voxel direction (``:458-560``);
2. refuses neighbour links with incompatible tensors/vectors
   (``:625-673``, including the reference's quirk of gating the signed
   vector comparison on the tensor and using
   ``threshold_tensor_neighbor`` for it);
3. merges colliding basins into clusters;
4. standardizes direction-vector signs per basin, cutting Moebius loops,
   and flips them outward by centre-of-mass dot products
   (``:697-772, 1186-1289``);
5. applies must-link constraints (``:829-1045``);
6. renumbers clusters (sorted by size or by seed value), labels 1..N,
   undefined -> ``label_undefined`` (``:1316-1426``).

Reference quirk replicated deliberately: ``TraceProductSym3``
(``lin3_utils.hpp:502-531``) indexes its 6x2 lookup table out of bounds
with constant indices; the compiled reads yield ``2*A0*B0 + A0*B1 +
A1*B0 + A1*B1 + A1*B2 + A2*B1 + 2*A2*B2``, which ignores the
off-diagonal channels.  Every tensor gate of the reference uses it, so
this port does (``trace_product_sym3_quirk``).

Where the work runs: the per-voxel gates, the seeds (``find_extrema``)
and the candidate compaction on the saliency's device, in torch; the
ordered flood on the host, in the native C++ core (``native/``).  The
gates go over z slabs with one halo plane, so no (Z, Y, X, 3, 3)
temporary of the whole volume exists; they read the channel-major
``(6, Z, Y, X)`` vote tensor and ``(3, Z, Y, X)`` vector in place (any
strides).  Only voxels that can ever be assigned -- inside the mask and
passing the flood's saliency threshold (``connect.hpp:520-538``) -- are
compacted (``torch.nonzero``, raster order) and copied to the host; the
native flood runs on that candidate set.  Labels, clusters, polarity and
the standardized vectors at every assigned voxel equal the dense
flood's; never-assigned voxels keep their input vector sign (the dense
flood may flip signs there while queueing voxels that then fail the
threshold, values no consumer reads).  Under ``-mesh`` the inputs are
ShardedVolumes: the gates read each block with a 2-deep halo of the
saliency, the seeds come from ``find_extrema`` on the blocks, and the
candidates are compacted per block and merged into the single-device
raster order before the same flood.  Over a mesh that spans the ranks
of a multi-process cluster each rank compacts its own blocks, the lists
are all-gathered (their merge sorts on the global raster index, one per
voxel, so the order they arrive in does not matter), and every rank runs
the same flood on the same lists, as every process of the JAX package
does after ``to_host_np``.

``_flood_python`` is the plain twin of the native flood (the tests hold
one against the other); nothing on the main path runs it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from visfd_tpu_torch import native
from visfd_tpu_torch.features.hessian import fd_slab, hessian_fd
from visfd_tpu_torch.linalg import sym3
from visfd_tpu_torch.parallel import distributed as D
from visfd_tpu_torch.parallel.gather import to_host_np
from visfd_tpu_torch.parallel.halo import haloed_block, with_ghosts
from visfd_tpu_torch.parallel.mesh import ShardedVolume
from visfd_tpu_torch.segment.extrema import (
    find_extrema, flat_to_xyz, neighbor_offsets)
from visfd_tpu_torch.utils.progress import Report, stage
from visfd_tpu_torch.utils.transfer import to_device, to_host

SAME_DIRECTION = "same"
OPPOSITE_DIRECTION = "opposite"
AUTO_DIRECTION = "auto"

SORT_BY_VALUE = "value"
SORT_BY_SIZE = "size"

# voxels of one z slab of the gates: about 20 float32 temporaries of
# (slab, 3, 3) live at once, ~1.5 GiB
GATE_SLAB_VOXELS = 1 << 22


def trace_product_sym3(a, b):
    """Correct trace(A B) of flat-6 symmetric matrices (last axis)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2]
            + 2.0 * (a[..., 3] * b[..., 3] + a[..., 4] * b[..., 4]
                     + a[..., 5] * b[..., 5]))


def trace_product_sym3_quirk(a, b):
    """The reference's compiled TraceProductSym3 (module docstring)."""
    return (2.0 * a[..., 0] * b[..., 0]
            + a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]
            + a[..., 1] * b[..., 1]
            + a[..., 1] * b[..., 2] + a[..., 2] * b[..., 1]
            + 2.0 * a[..., 2] * b[..., 2])


def frobenius_norm_sym3_quirk(a):
    return np.sqrt(np.maximum(trace_product_sym3_quirk(a, a), 0.0))


def gate_sides(hess, tensor, vector, threshold_tensor, threshold_vector,
               order, consider_sign):
    """The two sides of each discard gate (``connect.hpp:458-560``) at
    every voxel of a channel-last Hessian ``hess`` (..., 6): the
    trace-product gate against the channel-last ``tensor`` (..., 6),
    then the vector gate of the Hessian's principal eigenvector (after
    the Shoemake round trip, as the reference stores it) against
    ``vector`` (..., 3); either may be None.  A voxel is discarded where
    ``lhs < rhs`` for any (lhs, rhs) pair.  The thresholds are floats,
    rounded to float32 as the JAX package rounds them (the square of
    the vector threshold in float64 first)."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=hess.device)

    sides = []
    if tensor is not None:
        tp = trace_product_sym3_quirk(hess, tensor)
        fs = torch.sqrt(torch.clamp(trace_product_sym3_quirk(hess, hess),
                                    min=0.0))
        ft = torch.sqrt(torch.clamp(trace_product_sym3_quirk(tensor, tensor),
                                    min=0.0))
        # -inf * 0 -> nan compares False, as the C++ compare
        sides.append((tp, f32(threshold_tensor) * fs * ft))
    if vector is not None:
        diag = sym3.diagonalize_flat_sym3(hess, order=order)
        v1 = sym3.shoemake_to_matrix(diag[..., 3:6])[..., 0, :]
        dot = (v1 * vector).sum(-1)
        lv1 = torch.sqrt((v1 * v1).sum(-1))
        lv = torch.sqrt((vector * vector).sum(-1))
        if consider_sign:
            sides.append((dot, f32(threshold_vector) * lv1 * lv))
        else:
            sides.append((dot * dot, f32(float(threshold_vector) ** 2)
                          * lv1 * lv1 * lv * lv))
    return sides


def discard_gates(sal, tensor, vector, threshold_tensor, threshold_vector,
                  order, consider_sign, neg_hess,
                  slab_voxels: int = GATE_SLAB_VOXELS):
    """The per-voxel discard gates (``gate_sides``) on ``sal``'s device,
    from the saliency's FD Hessian (negated if ``neg_hess``), against
    the channel-major ``tensor`` (6, Z, Y, X) and ``vector`` (3, Z, Y,
    X), read in place.  Runs over z slabs of about ``slab_voxels``.
    Returns the (Z, Y, X) bool discard mask; for ShardedVolumes, one
    block at a time, the saliency read with a 2-deep halo (its Hessian
    at a block's faces reads one voxel past them, at the volume's faces
    one voxel further in)."""
    args = (threshold_tensor, threshold_vector, order, consider_sign,
            neg_hess, slab_voxels)
    if not isinstance(sal, ShardedVolume):
        nz, ny, _ = sal.shape
        return _gates(sal, (0, 0), sal.shape, 0, nz, 0, ny, tensor, vector,
                      *args)
    bz, by = sal.block_shape
    ghosted = with_ghosts(sal, 2, 2)

    def cell(iz, iy, b):
        return _gates(haloed_block(ghosted, iz, iy, 2),
                      (iz * bz - 2, iy * by - 2), sal.shape, iz * bz,
                      (iz + 1) * bz, iy * by, (iy + 1) * by,
                      None if tensor is None else tensor.blocks[iz][iy],
                      None if vector is None else vector.blocks[iz][iy],
                      *args)
    return sal.with_blocks(cell)


def _gates(src, org, shape, za, zb, ya, yb, tensor, vector, threshold_tensor,
           threshold_vector, order, consider_sign, neg_hess, slab_voxels):
    """The discard gates of the voxels [za, zb) x [ya, yb) x X of the
    global saliency, ``src`` holding its planes and rows from ``org`` on
    (``features.hessian.fd_slab``); ``tensor`` and ``vector`` cover just
    those voxels."""
    nz, ny, nx = shape
    if min(nz, ny) < 3:     # a whole thin volume: the plain stencil
        hess_of = lambda z0, z1: hessian_fd(src)[z0:z1]  # noqa: E731
    else:
        def hess_of(z0, z1):
            return fd_slab(src, z0, z1, ya, yb, org, shape)
    out = torch.zeros((zb - za, yb - ya, nx), dtype=torch.bool,
                      device=src.device)
    planes = max(1, slab_voxels // max((yb - ya) * nx, 1))
    for z0 in range(za, zb, planes):
        z1 = min(zb, z0 + planes)
        hess = hess_of(z0, z1)
        if neg_hess:
            hess = -hess
        sl = slice(z0 - za, z1 - za)
        for lhs, rhs in gate_sides(
                hess, None if tensor is None else tensor[:, sl].movedim(0, -1),
                None if vector is None else vector[:, sl].movedim(0, -1),
                threshold_tensor, threshold_vector, order, consider_sign):
            out[sl] |= lhs < rhs
    return out


def _candidate_bound_f32(threshold: float, sign: float):
    """The flood pops a voxel to UNDEF iff (in float64) ``sal * sign >
    threshold * sign``.  Returns ``(t32, pred_gt)`` such that the
    candidates among float32 saliencies are exactly ``~(sal > t32)``
    (pred_gt) or ``~(sal < t32)``: f32 -> f64 promotion is exact, so the
    float64 comparison reduces to a float32 one against the correctly
    rounded boundary.  NaN saliencies stay candidates, as in the
    flood."""
    t = np.float32(threshold)
    if sign > 0:  # UNDEF iff sal > threshold
        if np.float64(t) > threshold:
            t = np.nextafter(t, np.float32(-np.inf))
        return t, True
    # sign < 0: UNDEF iff sal < threshold
    if np.float64(t) < threshold:
        t = np.nextafter(t, np.float32(np.inf))
    return t, False


def find_nearest_voxel(labels, target_xyz, mask=None, exclude_label=None):
    """Nearest voxel (by Euclidean index distance) whose label is NOT
    ``exclude_label`` (``visfd_utils.hpp:144-186`` with
    invert_selection=true).  Returns (ix, iy, iz) or None."""
    sel = np.ones(labels.shape, bool)
    if mask is not None:
        sel &= np.asarray(mask) != 0
    if exclude_label is not None:
        sel &= labels != exclude_label
    if not sel.any():
        return None
    zz, yy, xx = np.nonzero(sel)
    tx, ty, tz = target_xyz
    d2 = (xx - tx) ** 2 + (yy - ty) ** 2 + (zz - tz) ** 2
    k = np.argmin(d2)
    return int(xx[k]), int(yy[k]), int(zz[k])


@dataclasses.dataclass
class ConnectResult:
    labels: np.ndarray            # (Z, Y, X) int64; clusters 1..N
    num_clusters: int
    cluster_maxima: np.ndarray    # (N, 3) (ix, iy, iz) seed of each cluster
    cluster_sizes: np.ndarray
    cluster_saliencies: np.ndarray
    vector_standardized: Optional[np.ndarray] = None  # (Z, Y, X, 3)


def _channel_last(t) -> Optional[np.ndarray]:
    """A channel-major (C, Z, Y, X) field as a C-contiguous (Z, Y, X, C)
    float32 host array (None passes)."""
    if t is None:
        return None
    return np.ascontiguousarray(to_host_np(t).transpose(1, 2, 3, 0),
                                np.float32)


def label_connected(
    saliency,                                   # (Z, Y, X)
    mask=None,
    threshold_saliency: float = -np.inf,
    vector=None,                                # (3, Z, Y, X) (x, y, z)
    threshold_vector_saliency: float = -np.inf,
    threshold_vector_neighbor: float = -np.inf,
    consider_dot_product_sign: bool = True,
    tensor=None,                                # (6, Z, Y, X)
    threshold_tensor_saliency: float = -np.inf,
    threshold_tensor_neighbor: float = -np.inf,
    tensor_is_positive_definite_near_target: bool = True,
    connectivity: int = 1,
    label_undefined: int = -1,
    sort_criteria: str = SORT_BY_SIZE,
    standardize_vector_sign: bool = False,
    must_link: Optional[Sequence[Sequence[Tuple[float, float, float]]]] = None,
    must_link_directions: Optional[Sequence[Sequence[str]]] = None,
    start_from_saliency_maxima: bool = True,
    compact: bool = True,
    want_dense_vectors: bool = True,
    report: Optional[Report] = None,
) -> ConnectResult:
    """``saliency``, ``mask``, ``vector`` and ``tensor`` are tensors on
    one device (the gates, seeds and compaction run there), numpy arrays
    (on the CPU), or ShardedVolumes of one partition (the gates, seeds
    and compaction run block by block, the candidate lists merged into
    the single-device raster order: the same labels).  Unlike the JAX package, ``tensor`` and
    ``vector`` are CHANNEL-MAJOR, (6, Z, Y, X) and (3, Z, Y, X), and are
    read in place.  ``compact=False`` runs the dense native flood over
    the whole volume (same labels).  ``want_dense_vectors``: build
    ``vector_standardized`` as a full (Z, Y, X, 3) host field (the PLY
    writer reads it); False skips it, labels and cluster statistics
    unchanged.  ``report`` collects the stage spans and counts the
    copies of the inputs and the candidates."""
    rep = report if report is not None else Report(None)
    sharded = isinstance(saliency, ShardedVolume)
    sal = saliency if sharded else torch.as_tensor(saliency,
                                                   dtype=torch.float32)
    dev = sal.local_block.device if sharded else sal.device

    tensor, vector, mask_t = (
        t if t is None or isinstance(t, ShardedVolume)
        else to_device(t, dev, rep, torch.float32)
        for t in (tensor, vector, mask))
    nz, ny, nx = shape = tuple(sal.shape)
    for name, t, c in (("tensor", tensor, 6), ("vector", vector, 3)):
        if t is not None and tuple(t.shape) != (c,) + shape:
            raise ValueError(f"label_connected: {name} must be channel-major "
                             f"{(c,) + shape}, got {tuple(t.shape)}")
    offs = neighbor_offsets(connectivity)
    sign = -1.0 if start_from_saliency_maxima else 1.0
    order = (sym3.EigenOrder.DECREASING if start_from_saliency_maxima
             else sym3.EigenOrder.INCREASING)
    if not consider_dot_product_sign:
        # connect.hpp:209-227
        threshold_vector_saliency = max(threshold_vector_saliency, 0.0)
        threshold_vector_neighbor = max(threshold_vector_neighbor, 0.0)

    discard = None
    if tensor is not None or vector is not None:
        with stage("connect: gates", rep):
            discard = discard_gates(
                sal, tensor, vector, threshold_tensor_saliency,
                threshold_vector_saliency, order, consider_dot_product_sign,
                neg_hess=(tensor_is_positive_definite_near_target
                          == start_from_saliency_maxima))

    with stage("connect: seeds", rep):
        res = find_extrema(
            sal, mask=mask_t, connectivity=connectivity,
            find_minima=not start_from_saliency_maxima,
            find_maxima=start_from_saliency_maxima,
            minima_threshold=(threshold_saliency
                              if not start_from_saliency_maxima else np.inf),
            maxima_threshold=(threshold_saliency
                              if start_from_saliency_maxima else -np.inf),
            allow_borders=True, want_label_image=False)
    if start_from_saliency_maxima:
        seed_flat, seed_scores = res.maxima_indices, res.maxima_scores
    else:
        seed_flat, seed_scores = res.minima_indices, res.minima_scores
    n_basins = len(seed_flat)
    rep.record_count("connect seeds", n_basins)
    seed_locs = np.stack(flat_to_xyz(np.asarray(seed_flat, np.int64), shape),
                         axis=-1).reshape(-1, 3)
    UNDEF = n_basins + 1
    want_vec_std = (vector is not None and standardize_vector_sign
                    and not consider_dot_product_sign)
    valid = None if mask is None else to_host_np(mask, report=rep) != 0
    thr_n = (threshold_tensor_neighbor, threshold_vector_neighbor)

    if compact:
        # must-link merge/flip decisions sample the dense standardized
        # field at arbitrary voxels, so they force the reconstruction
        want_dense = bool(want_dense_vectors or (must_link and want_vec_std))
        labels, basin2cluster, basin2polarity, vec_std = _flood_compact(
            sal, discard, mask_t, offs, sign, threshold_saliency, tensor,
            vector, *thr_n, consider_dot_product_sign, want_vec_std,
            seed_locs, seed_scores, want_dense, rep)
        cluster2basins = None
    else:
        vec_cl = _channel_last(vector)
        with stage("connect: native flood", rep):
            (labels, basin2cluster, cluster2basins, basin2polarity, vec_std,
             _) = _flood_native(
                to_host_np(sal, report=rep), valid,
                np.zeros(shape, bool) if discard is None
                else to_host_np(discard, report=rep),
                seed_locs, seed_scores, n_basins, offs, sign,
                threshold_saliency, _channel_last(tensor), vec_cl, *thr_n,
                consider_dot_product_sign,
                vec_cl.copy() if want_vec_std else None)

    with stage("connect: finalize", rep):
        return _finalize_connect(
            seed_scores, valid, labels, n_basins, UNDEF, basin2cluster,
            cluster2basins, basin2polarity, vec_std, seed_locs, must_link,
            must_link_directions, sort_criteria, label_undefined, rep)


def _flood_compact(sal, discard, mask_t, offs, sign, threshold_saliency,
                   tensor, vector, threshold_tensor_neighbor,
                   threshold_vector_neighbor, consider_sign, want_vec_std,
                   seed_locs, seed_scores, want_dense_vectors, rep):
    """Candidate compaction on the device, then the native
    ``visfd_connect_flood_compact`` over the candidate lists on the
    host.  Returns (labels, basin2cluster, basin2polarity, vec_std)."""
    nz, ny, nx = shape = tuple(sal.shape)
    n_basins = len(seed_locs)
    if isinstance(sal, ShardedVolume):
        zyx, sal_c, disc_c, tens_c, vec_c = _candidates_sharded(
            sal, discard, mask_t, tensor, vector, threshold_saliency, sign,
            rep)
    else:
        with stage("connect: candidate mask + compaction", rep):
            parts = compact_candidates(sal, discard, mask_t, tensor, vector,
                                       threshold_saliency, sign)
        with stage("connect: candidate copy", rep):
            zyx, sal_c, disc_c, tens_c, vec_c = (
                None if p is None else to_host(p, rep) for p in parts)
            del parts
    n_cand = len(zyx)
    rep.record_count("connect candidates", n_cand)

    with stage("connect: native flood", rep):
        idx = (zyx[:, 0] * ny + zyx[:, 1]) * nx + zyx[:, 2]
        cand_id = np.full(nz * ny * nx, -1, np.int32)
        cand_id[idx] = np.arange(n_cand, dtype=np.int32)
        vec_std_c = vec_c.copy() if want_vec_std else None
        labels = np.empty(shape, np.int64)
        basin2cluster = np.empty(max(n_basins, 1), np.int64)
        basin2polarity = np.empty(max(n_basins, 1), np.int8)
        seeds_c, scores_c, offs_c = _flood_args(seed_locs, seed_scores, offs)
        lib = native.load()
        lib.visfd_connect_flood_compact(
            native.ptr(cand_id, ctypes.c_int32),
            native.ptr(sal_c, ctypes.c_float),
            native.ptr(disc_c, ctypes.c_uint8),
            nz, ny, nx,
            native.ptr(seeds_c, ctypes.c_int32),
            native.ptr(scores_c, ctypes.c_float), n_basins,
            native.ptr(offs_c, ctypes.c_int32), len(offs),
            float(sign), float(threshold_saliency),
            native.ptr(tens_c, ctypes.c_float),
            native.ptr(vec_c, ctypes.c_float),
            float(threshold_tensor_neighbor),
            float(threshold_vector_neighbor),
            int(consider_sign),
            native.ptr(vec_std_c, ctypes.c_float),
            native.ptr(labels, ctypes.c_int64),
            native.ptr(basin2cluster, ctypes.c_int64),
            native.ptr(basin2polarity, ctypes.c_int8))
        del cand_id

    vec_std = None
    if want_vec_std and want_dense_vectors:
        # dense standardized vectors: input signs everywhere, the flood's
        # signs at the candidates (assigned voxels included)
        vec_std = _channel_last(vector)
        vec_std.reshape(-1, 3)[idx] = vec_std_c
    return (labels, basin2cluster[:n_basins], basin2polarity[:n_basins],
            vec_std)


def compact_candidates(sal, discard, mask_t, tensor, vector,
                       threshold_saliency, sign):
    """The voxels the flood can assign (inside the mask and passing its
    pop threshold, ``_candidate_bound_f32``), in raster order, on
    ``sal``'s device: [(n, 3) int64 (z, y, x), saliency (n,), discard
    (n,) uint8, tensor (n, 6) or None, vector (n, 3) or None], the
    fields gathered from their channel-major layout."""
    t32, pred_gt = _candidate_bound_f32(threshold_saliency, sign)
    t32 = torch.tensor(t32, dtype=torch.float32, device=sal.device)
    cand = ~((sal > t32) if pred_gt else (sal < t32))
    if mask_t is not None:
        cand &= mask_t != 0
    zyx = torch.nonzero(cand)
    del cand
    z, y, x = zyx.unbind(1)
    return [zyx, sal[z, y, x],
            (torch.zeros_like(z, dtype=torch.uint8) if discard is None
             else discard[z, y, x].to(torch.uint8))] + [
        None if f is None else f[:, z, y, x].T.contiguous()
        for f in (tensor, vector)]


def _candidates_sharded(sal, discard, mask_t, tensor, vector,
                        threshold_saliency, sign, rep):
    """``compact_candidates`` block by block, each block's lists copied
    to the host with global (z, y, x), then merged into the
    single-device raster order (all-gathered first when the blocks span
    ranks)."""
    bz, by = sal.block_shape
    lists = []
    with stage("connect: candidate mask + compaction + copy", rep):
        for iz, iy, b in sal.cells():
            def blk(v):
                return None if v is None else v.blocks[iz][iy]
            parts = compact_candidates(
                b, blk(discard), blk(mask_t), blk(tensor), blk(vector),
                threshold_saliency, sign)
            host = [None if p is None else to_host(p, rep) for p in parts]
            host[0] = host[0] + np.array([iz * bz, iy * by, 0])
            lists.append(host)
            del parts
    with stage("connect: candidate merge", rep):
        _, ny, nx = sal.shape
        parts = [None if p[0] is None else np.concatenate(p)
                 for p in zip(*lists)]
        del lists
        if sal.mesh.spans_processes:
            parts = [None if p is None else D.allgather_concat(p)
                     for p in parts]
        zyx = parts[0]
        srt = np.argsort((zyx[:, 0] * ny + zyx[:, 1]) * nx + zyx[:, 2],
                         kind="stable")
        return [None if p is None else np.ascontiguousarray(p[srt])
                for p in parts]


def _flood_args(seed_locs, seed_scores, offs):
    return (np.ascontiguousarray(np.asarray(seed_locs, np.int32)
                                 .reshape(-1, 3)),
            np.ascontiguousarray(seed_scores, np.float32),
            np.ascontiguousarray(np.asarray(offs, np.int32).reshape(-1, 3)))


def _flood_native(saliency, valid, discard, seed_locs, seed_scores,
                  n_basins, offs, sign, threshold_saliency, tensor, vector,
                  threshold_tensor_neighbor, threshold_vector_neighbor,
                  consider_dot_product_sign, vec_std):
    """The dense native flood (``visfd_connect_flood``) over host arrays
    (channel-last tensor and vector; ``vec_std`` is standardized in
    place).  Same arguments and results as ``_flood_python``; the
    cluster -> basins map is rebuilt from basin2cluster (a merge always
    keeps min(ci, cj))."""
    nz, ny, nx = saliency.shape

    def c(a, dtype):
        return None if a is None else np.ascontiguousarray(a, dtype)

    if vec_std is not None and not (vec_std.flags.c_contiguous
                                    and vec_std.dtype == np.float32):
        raise ValueError("vec_std must be C-contiguous float32")
    seeds_c, scores_c, offs_c = _flood_args(seed_locs, seed_scores, offs)
    sal_c, valid_c, discard_c = (c(saliency, np.float32), c(valid, np.uint8),
                                 c(discard, np.uint8))
    tensor_c, vector_c = c(tensor, np.float32), c(vector, np.float32)
    labels = np.empty(saliency.shape, np.int64)
    basin2cluster = np.empty(max(n_basins, 1), np.int64)
    basin2polarity = np.empty(max(n_basins, 1), np.int8)
    cut = native.load().visfd_connect_flood(
        native.ptr(sal_c, ctypes.c_float),
        native.ptr(valid_c, ctypes.c_uint8),
        native.ptr(discard_c, ctypes.c_uint8),
        nz, ny, nx,
        native.ptr(seeds_c, ctypes.c_int32),
        native.ptr(scores_c, ctypes.c_float), n_basins,
        native.ptr(offs_c, ctypes.c_int32), len(offs),
        float(sign), float(threshold_saliency),
        native.ptr(tensor_c, ctypes.c_float),
        native.ptr(vector_c, ctypes.c_float),
        float(threshold_tensor_neighbor),
        float(threshold_vector_neighbor),
        int(consider_dot_product_sign),
        native.ptr(vec_std, ctypes.c_float),
        native.ptr(labels, ctypes.c_int64),
        native.ptr(basin2cluster, ctypes.c_int64),
        native.ptr(basin2polarity, ctypes.c_int8))
    basin2cluster = basin2cluster[:n_basins]
    return (labels, basin2cluster, _cluster2basins(basin2cluster),
            basin2polarity[:n_basins], vec_std, bool(cut))


def _cluster2basins(basin2cluster) -> List[set]:
    out = [set() for _ in range(len(basin2cluster))]
    for b, c in enumerate(basin2cluster):
        if c >= 0:
            out[int(c)].add(b)
    return out


def _flood_python(saliency, valid, discard, seed_locs, seed_scores,
                  n_basins, offs, sign, threshold_saliency, tensor,
                  vector, threshold_tensor_neighbor,
                  threshold_vector_neighbor, consider_dot_product_sign,
                  vec_std):
    """Pure-Python LabelConnected flood, the plain twin of the native
    core (host arrays; tensor and vector channel-last)."""
    nz, ny, nx = saliency.shape
    UNDEF = n_basins + 1
    QUEUED = n_basins + 2
    labels = np.full(saliency.shape, UNDEF, np.int64)
    basin2cluster = np.arange(n_basins, dtype=np.int64)
    cluster2basins: List[set] = [set([i]) for i in range(n_basins)]
    basin2polarity = np.ones(n_basins, np.int8)
    seeds = [tuple(int(v) for v in s) for s in np.reshape(seed_locs, (-1, 3))]

    q = []
    for i, (ix, iy, iz) in enumerate(seeds):
        heapq.heappush(q, (float(seed_scores[i]) * sign, -i,
                           (-ix, -iy, -iz)))
        labels[iz, iy, ix] = QUEUED

    def pair_link_ok(ci, cj):
        """Neighbour-link gates (connect.hpp:625-673); ci and cj are
        (iz, iy, ix) tuples."""
        if tensor is not None:
            ti = tensor[ci]
            tj = tensor[cj]
            if trace_product_sym3_quirk(ti, tj) < (
                    threshold_tensor_neighbor
                    * frobenius_norm_sym3_quirk(ti)
                    * frobenius_norm_sym3_quirk(tj)):
                return False
            if vector is None:
                return True  # tensor without vector: skip the gate
            # reference quirk: this vector check is gated on the TENSOR
            # being present, and the signed branch compares against
            # threshold_tensor_neighbor (connect.hpp:646-673)
            vi, vj = vector[ci], vector[cj]
            dot = float(vi @ vj)
            li = float(np.linalg.norm(vi))
            lj = float(np.linalg.norm(vj))
            if consider_dot_product_sign:
                if dot < threshold_tensor_neighbor * li * lj:
                    return False
            else:
                if dot * dot < (threshold_vector_neighbor ** 2
                                * li * li * lj * lj):
                    return False
        return True

    voxels_cut_due_to_polarity = False
    while q:
        score, neg_basin, neg_crd = heapq.heappop(q)
        basin = -neg_basin
        ix, iy, iz = -neg_crd[0], -neg_crd[1], -neg_crd[2]

        if score > threshold_saliency * sign:
            labels[iz, iy, ix] = UNDEF
            continue
        if valid is not None and not valid[iz, iy, ix]:
            labels[iz, iy, ix] = UNDEF
            continue
        if discard[iz, iy, ix]:
            labels[iz, iy, ix] = UNDEF
            if (ix, iy, iz) == seeds[basin]:
                basin2cluster[basin] = -1
            continue

        labels[iz, iy, ix] = basin
        for dz, dy, dx in offs:
            z, y, x = iz + dz, iy + dy, ix + dx
            if not (0 <= z < nz and 0 <= y < ny and 0 <= x < nx):
                continue
            if valid is not None and not valid[z, y, x]:
                continue
            if not pair_link_ok((iz, iy, ix), (z, y, x)):
                continue
            nlab = labels[z, y, x]
            if nlab == QUEUED:
                continue
            if nlab == UNDEF:
                labels[z, y, x] = QUEUED
                heapq.heappush(q, (float(saliency[z, y, x]) * sign,
                                   -basin, (-x, -y, -z)))
                if vec_std is not None:
                    if float(vec_std[iz, iy, ix] @ vec_std[z, y, x]) < 0.0:
                        vec_std[z, y, x] = -vec_std[z, y, x]
            else:
                basin_j = nlab
                ci = basin2cluster[basin]
                cj = basin2cluster[basin_j]
                polarity_match = True
                if vec_std is not None:
                    if (float(vec_std[iz, iy, ix] @ vec_std[z, y, x])
                            * basin2polarity[basin]
                            * basin2polarity[basin_j]) < 0.0:
                        polarity_match = False
                if ci == cj:
                    if not polarity_match:
                        voxels_cut_due_to_polarity = True
                    continue
                merged, deleted = min(ci, cj), max(ci, cj)
                for b in cluster2basins[deleted]:
                    cluster2basins[merged].add(b)
                    basin2cluster[b] = merged
                    if vec_std is not None and not polarity_match:
                        basin2polarity[b] = -basin2polarity[b]
                cluster2basins[deleted].clear()

    return (labels, basin2cluster, cluster2basins, basin2polarity,
            vec_std, voxels_cut_due_to_polarity)


def _apply_must_link(labels, valid, UNDEF, basin2cluster, cluster2basins,
                     basin2polarity, vec_std, must_link,
                     must_link_directions):
    """Must-link constraints (connect.hpp:829-1045): merge the clusters
    of the voxels nearest each group's points, flipping the polarity of
    the merged basins where the directions disagree."""
    for gi, group in enumerate(must_link):
        basin_j = None
        r_j = None
        for li_, loc in enumerate(group):
            target = tuple(int(np.floor(c + 0.5)) for c in loc)
            r_i = find_nearest_voxel(labels, target, mask=valid,
                                     exclude_label=UNDEF)
            if r_i is None:
                raise ValueError(
                    "No voxels clustered; must-link target unreachable")
            basin_i = int(labels[r_i[2], r_i[1], r_i[0]])
            if basin_j is not None and basin_i != basin_j:
                ci = basin2cluster[basin_i]
                cj = basin2cluster[basin_j]
                if ci != cj:
                    merged, deleted = min(ci, cj), max(ci, cj)
                    flip = False
                    if vec_std is not None:
                        n_i = vec_std[r_i[2], r_i[1], r_i[0]]
                        n_j = vec_std[r_j[2], r_j[1], r_j[0]]
                        rij = np.array(r_i, float) - np.array(r_j, float)
                        nrm = np.linalg.norm(rij)
                        rij = rij / nrm if nrm > 0 else rij
                        mode = AUTO_DIRECTION
                        if must_link_directions is not None:
                            mode = must_link_directions[gi][li_]
                        if mode == SAME_DIRECTION:
                            pm = float(n_i @ n_j) > 0
                        elif mode == OPPOSITE_DIRECTION:
                            pm = float(n_i @ n_j) < 0
                        else:
                            nid = float(n_i @ rij)
                            njd = float(n_j @ rij)
                            th0 = np.pi / 4
                            if (np.arcsin(min(abs(nid), 1.0)) < th0
                                    and np.arcsin(min(abs(njd), 1.0))
                                    < th0):
                                pm = float(n_i @ n_j) > 0
                            else:
                                pm = nid * njd <= 0
                        flip = pm != (basin2polarity[basin_i]
                                      == basin2polarity[basin_j])
                    for b in cluster2basins[deleted]:
                        cluster2basins[merged].add(b)
                        basin2cluster[b] = merged
                        if vec_std is not None and flip:
                            basin2polarity[b] = -basin2polarity[b]
                    cluster2basins[deleted].clear()
            basin_j = basin_i
            r_j = r_i


def _finalize_connect(seed_values, valid, labels, n_basins, UNDEF,
                      basin2cluster, cluster2basins, basin2polarity,
                      vec_std, seed_locs, must_link, must_link_directions,
                      sort_criteria, label_undefined, report):
    """The host stages after the flood: must-link merging, cluster
    renumbering, polarity, the outward flip, sorting
    (connect.hpp:829-1426).  A voxel's output depends only on its basin
    label, so the labels go through one lookup table over the label
    values (the basins, UNDEF and QUEUED) instead of volume-sized
    passes; per-voxel passes run only for the standardized vectors."""
    if must_link:
        if cluster2basins is None:
            cluster2basins = _cluster2basins(basin2cluster)
        _apply_must_link(labels, valid, UNDEF, basin2cluster, cluster2basins,
                         basin2polarity, vec_std, must_link,
                         must_link_directions)

    # ---- renumber clusters: the roots in basin order ----
    is_root = basin2cluster == np.arange(n_basins)
    n_clusters = int(is_root.sum())
    old2new = np.cumsum(is_root) - is_root
    cluster2deepest = np.flatnonzero(is_root)
    report.line(f"Number of clusters found: {n_clusters}")
    report.record_count("connect clusters", n_clusters)
    b2c = np.where(basin2cluster >= 0,
                   old2new[np.clip(basin2cluster, 0, max(n_basins - 1, 0))],
                   -1).astype(np.int64)
    # label value -> cluster id (-1: UNDEF, QUEUED)
    lut = np.full(n_basins + 3, -1, np.int64)
    lut[:n_basins] = b2c

    # cluster sizes: the voxel counts of their basins
    sizes = np.zeros(max(n_clusters, 1), np.float64)
    counts = np.bincount(labels.reshape(-1), minlength=n_basins + 3)
    ok = b2c >= 0
    np.add.at(sizes, b2c[ok], counts[:n_basins][ok].astype(np.float64))

    if vec_std is not None and n_basins > 0:
        # per-basin polarity, then the outward orientation
        # (connect.hpp:1186-1289)
        in_basin = labels < n_basins
        pol = basin2polarity[np.clip(labels, 0, n_basins - 1)]
        vec_std = np.where(in_basin[..., None],
                           vec_std * pol[..., None].astype(np.float32),
                           vec_std)
        if n_clusters > 0:
            cl = lut[labels]
            sel = cl >= 0
            zz, yy, xx = np.nonzero(sel)
            cid = cl[sel]
            xyz = np.stack([xx, yy, zz], -1)
            com = np.zeros((n_clusters, 3))
            np.add.at(com, cid, xyz)
            com /= sizes[:n_clusters, None]
            dots = np.einsum("nd,nd->n", xyz - com[cid], vec_std[sel])
            sums = np.zeros(n_clusters)
            np.add.at(sums, cid, dots)
            flip_sel = sums[cid] < 0.0
            v = vec_std[sel]
            v[flip_sel] = -v[flip_sel]
            vec_std[sel] = v

    maxima = np.asarray(seed_locs, np.int64).reshape(-1, 3)[cluster2deepest]
    saliencies = np.asarray(seed_values, np.float32)[cluster2deepest]
    sizes_sorted = sizes[:n_clusters]
    if sort_criteria == SORT_BY_SIZE and n_clusters > 0:
        perm = np.lexsort((-np.arange(n_clusters), -sizes[:n_clusters]))
        inv = np.empty(n_clusters, np.int64)
        inv[perm] = np.arange(n_clusters)
        lut = np.where(lut >= 0, inv[np.clip(lut, 0, n_clusters - 1)], -1)
        maxima, sizes_sorted, saliencies = (maxima[perm], sizes_sorted[perm],
                                            saliencies[perm])
    out = np.where(lut >= 0, lut + 1, label_undefined)[labels]
    if valid is not None:
        # outside the mask the reference leaves dest at its flooded state
        # (never assigned: UNDEF), without the label_undefined remapping
        out[~valid] = UNDEF
    return ConnectResult(labels=out, num_clusters=n_clusters,
                         cluster_maxima=maxima, cluster_sizes=sizes_sorted,
                         cluster_saliencies=saliencies,
                         vector_standardized=vec_std)
