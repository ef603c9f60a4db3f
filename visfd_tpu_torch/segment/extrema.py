"""Plateau-aware local extrema detection, on the tensor's device.

Port of ``visfd_tpu/segment/extrema.py`` (``_FindExtrema``,
``morphology_implementation.hpp:55-515``): a local minimum/maximum is a
connected *plateau* of equal-valued voxels (connectivity 1/2/3 = squared
neighbour radius) all of whose outside neighbours are strictly
higher/lower.  Plateaus touching the image border or the mask boundary
are disqualified when ``allow_borders=False``.  Results are sorted
(minima ascending, maxima descending by score; ties keep raster
discovery order like the reference's tuple sort); an optional label
image marks maxima plateaus with +rank, minima with -rank, 0 elsewhere
(positive only when a single kind is requested).

The work walks the (z, y) blocks of a ``parallel.mesh.ShardedVolume``
(a plain tensor is the one block of a 1 x 1 grid; the mesh form is
``parallel.sharded_features.find_extrema_sharded``), each block reading
its neighbours through a 1-voxel halo (``parallel.halo.halo1``):

1. per-voxel neighbour comparisons give has_lower / has_higher /
   touches_border / has_same flags; an out-of-bounds or masked
   neighbour is not usable, and NaN compares false, as in the JAX
   package;
2. fast path, when voxels with an equal-valued neighbour are rare: the
   singleton extrema are compacted with ``torch.nonzero`` and only their
   (index, score) lists reach the host, merged in raster order; the
   plateau voxels are compacted too and their components built on the
   host with ``scipy.sparse.csgraph.connected_components`` (each root is
   the plateau's smallest flat index, the reference's raster-first
   representative);
3. plateau-heavy inputs (integer-valued images): min-label propagation
   with pointer jumps on the device until nothing changes, then
   ``postprocess_extrema`` on the host.

Over a mesh that spans ranks the halos come from
``parallel.halo.with_ghosts``, the plateau-voxel count that picks the
route is summed over the ranks, and the compacted lists are
all-gathered before the merge: every rank returns the same lists.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import torch

from visfd_tpu_torch.parallel import distributed as D
from visfd_tpu_torch.parallel.blocks import SENT, Geom, fixpoint, nb
from visfd_tpu_torch.parallel.gather import to_host_np
from visfd_tpu_torch.parallel.halo import halo1, with_ghosts
from visfd_tpu_torch.parallel.mesh import ShardedVolume, as_blocks, bmap
from visfd_tpu_torch.utils.transfer import to_host


def neighbor_offsets(connectivity: int) -> Tuple[Tuple[int, int, int], ...]:
    """Neighbour displacement set: all (dz, dy, dx) != 0 with
    dx^2 + dy^2 + dz^2 <= connectivity
    (``morphology_implementation.hpp:132-160``)."""
    r = int(np.floor(np.sqrt(connectivity)))
    offs = []
    for dz in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if (dx, dy, dz) == (0, 0, 0):
                    continue
                if dx * dx + dy * dy + dz * dz > connectivity:
                    continue
                offs.append((dz, dy, dx))
    return tuple(offs)


def flat_to_xyz(index, shape_zyx):
    """flat index ix + nx*(iy + ny*iz) -> (ix, iy, iz) (ints or arrays)."""
    nz, ny, nx = shape_zyx
    ix = index % nx
    iy = (index // nx) % ny
    iz = index // (nx * ny)
    return ix, iy, iz


def _block_flags(xp, vp, offsets):
    """(has_lt, has_gt, border, has_same) of a block's voxels, each &
    valid, from its values and validity padded by one voxel (validity
    False beyond the volume): does a usable neighbour (in the volume and
    the mask) compare lower, higher, equal; is a neighbour unusable.  NaN
    compares false, as in the JAX package."""
    c, v = nb(xp, (0, 0, 0)), nb(vp, (0, 0, 0))
    has_lt, has_gt, has_same, border = (torch.zeros_like(v)
                                        for _ in range(4))
    for off in offsets:
        u, nv = nb(vp, off), nb(xp, off)
        border |= ~u
        has_lt |= u & (nv < c)
        has_gt |= u & (nv > c)
        has_same |= u & (nv == c)
    return has_lt & v, has_gt & v, border & v, has_same & v


def _f32_bound(thr, is_min):
    """The float32 boundary that reproduces the host's float64
    comparison exactly (f32 -> f64 promotion is exact)."""
    t32 = np.float32(thr)
    if is_min:
        if np.float64(t32) > thr:
            t32 = np.nextafter(t32, np.float32(-np.inf))
    else:
        if np.float64(t32) < thr:
            t32 = np.nextafter(t32, np.float32(np.inf))
    return t32


def _scalar(t32, x):
    return torch.tensor(t32, dtype=torch.float32, device=x.device)


def _relevant(x, tmin, tmax, find_minima, find_maxima):
    """Voxels that could pass a requested threshold: a plateau has ONE
    value, so plateau connectivity among voxels that fail both cannot
    change any output (this keeps a thresholded saliency's zero plateau
    off the full propagation)."""
    rel = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if find_minima:
        rel |= x <= _scalar(tmin, x)
    if find_maxima:
        rel |= x >= _scalar(tmax, x)
    return rel


def _plateau_gather(x, valid, has_lt, has_gt, border, has_same, offsets):
    """The (rare) plateau voxels compacted to the host: (z, y, x)
    indices, values, flags, and per offset whether the neighbour there is
    in bounds, in the mask and equal."""
    nz, ny, nx = x.shape
    z, y, xx = torch.nonzero(has_same, as_tuple=True)
    vals = x[z, y, xx]
    sames = []
    for dz, dy, dx in offsets:
        z2, y2, x2 = z + dz, y + dy, xx + dx
        inb = ((z2 >= 0) & (z2 < nz) & (y2 >= 0) & (y2 < ny)
               & (x2 >= 0) & (x2 < nx))
        z2, y2, x2 = z2.clamp(0, nz - 1), y2.clamp(0, ny - 1), \
            x2.clamp(0, nx - 1)
        sames.append(inb & valid[z2, y2, x2] & (x[z2, y2, x2] == vals))
    host = [to_host(t) for t in (
        torch.stack([z, y, xx], -1), vals, has_lt[z, y, xx],
        has_gt[z, y, xx], border[z, y, xx],
        torch.stack(sames, -1) if sames
        else torch.zeros((len(z), 0), dtype=torch.bool))]
    return host


def _plateau_reduce(zyx, vals, p_lt, p_gt, p_bd, same_mat, offsets, shape):
    """Plateau components of the compacted plateau voxels, from
    ``scipy.sparse.csgraph.connected_components`` over their
    equal-neighbour links.  Returns, in ascending root order, (root
    flat index = the smallest member, value, size, has_lt, has_gt,
    border, member flat indices) per plateau."""
    nz, ny, nx = shape
    idx = (zyx[:, 0].astype(np.int64) * ny + zyx[:, 1]) * nx + zyx[:, 2]
    n = len(idx)
    if n == 0:
        return []
    # idx is ascending (raster order): a link's far end by binary search
    rows, cols = [], []
    for o, (dz, dy, dx) in enumerate(offsets):
        k = np.nonzero(same_mat[:, o])[0]
        far = idx[k] + ((dz * ny) + dy) * nx + dx
        j = np.clip(np.searchsorted(idx, far), 0, n - 1)
        hit = idx[j] == far
        rows.append(k[hit])
        cols.append(j[hit])
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    graph = scipy.sparse.coo_matrix(
        (np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n))
    _, comp = scipy.sparse.csgraph.connected_components(graph,
                                                        directed=False)
    # components numbered by first member: ascending root order
    order = np.argsort(comp, kind="stable")
    starts = np.flatnonzero(np.r_[True, np.diff(comp[order]) != 0])
    ends = np.r_[starts[1:], n]
    out = []
    for a, b in sorted(zip(starts, ends), key=lambda se: order[se[0]]):
        mi = order[a:b]
        out.append((int(idx[mi[0]]), float(vals[mi[0]]), len(mi),
                    bool(p_lt[mi].any()), bool(p_gt[mi].any()),
                    bool(p_bd[mi].any()), idx[mi]))
    return out


def _extrema_device(xs, valid, offsets) -> ShardedVolume:
    """Plateau labels (the smallest flat index of each equal-valued
    component, -1 outside the mask) by min-label propagation over the
    blocks (a halo exchange each round) with block-local pointer jumps,
    until no block changes."""
    geom = Geom(xs)
    pads = {(iz, iy): (halo1(xs, iz, iy, float("nan")),
                       halo1(valid, iz, iy, False))
            for iz, iy, _ in xs.cells()}

    def step(lab):
        flags = []
        lab_g = with_ghosts(lab, 1, 1)

        def cell(iz, iy, l0):
            xp, vp = pads[iz, iy]
            lp = halo1(lab_g, iz, iy, SENT)
            c, new = nb(xp, (0, 0, 0)), l0
            for off in offsets:
                eq = nb(vp, off) & (nb(xp, off) == c)
                new = torch.where(eq, torch.minimum(new, nb(lp, off)), new)
            inblk, (jl,) = geom.jump(iz, iy, new)
            new = torch.where(inblk, jl, new)
            flags.append((new != l0).any())
            return new
        return lab.with_blocks(cell), flags

    lab, _ = fixpoint(step, xs.with_blocks(
        lambda iz, iy, b: geom.idx(iz, iy, b.device)))
    return bmap(lambda t, v: torch.where(v, t, -1), lab, valid)


@dataclasses.dataclass
class ExtremaResult:
    minima_indices: np.ndarray   # flat indices ix + nx*(iy + ny*iz)
    minima_scores: np.ndarray
    minima_nvoxels: np.ndarray
    maxima_indices: np.ndarray
    maxima_scores: np.ndarray
    maxima_nvoxels: np.ndarray
    label_image: Optional[np.ndarray] = None

    @property
    def num_extrema(self) -> int:
        return len(self.minima_indices) + len(self.maxima_indices)


def find_extrema(
    x,
    mask=None,
    find_minima: bool = True,
    find_maxima: bool = True,
    minima_threshold: float = np.inf,
    maxima_threshold: float = -np.inf,
    connectivity: int = 3,
    allow_borders: bool = True,
    want_label_image: bool = True,
) -> ExtremaResult:
    """Find plateau extrema of the (Z, Y, X) ``x``: a tensor (computed on
    its device), a numpy array (on the CPU) or a ShardedVolume (block by
    block, ``mask`` then of the same partition); see the module
    docstring."""
    xs = as_blocks(x if isinstance(x, ShardedVolume)
                   else torch.as_tensor(x, dtype=torch.float32))
    if mask is None:
        valid = xs.with_blocks(lambda iz, iy, b: torch.ones_like(
            b, dtype=torch.bool))
    else:
        valid = bmap(lambda m: m != 0, mask if isinstance(
            mask, ShardedVolume) else as_blocks(torch.as_tensor(
                mask, device=xs.local_block.device)))
    spans = xs.mesh.spans_processes
    xs, valid = with_ghosts(xs, 1, 1), with_ghosts(valid, 1, 1)
    offs = neighbor_offsets(connectivity)
    _, ny, nx = xs.shape
    bz, by = xs.block_shape
    t32_min = _f32_bound(minima_threshold, is_min=True)
    t32_max = _f32_bound(maxima_threshold, is_min=False)
    flags, n_same = {}, 0
    for iz, iy, b in xs.cells():
        f = list(_block_flags(halo1(xs, iz, iy, float("nan")),
                              halo1(valid, iz, iy, False), offs))
        f[3] &= _relevant(b, t32_min, t32_max, find_minima, find_maxima)
        n_same += int(f[3].sum())
        flags[iz, iy] = f
    if spans:
        n_same = int(D.allreduce_sum(np.int64(n_same)))
    if n_same * max(len(offs), 1) > int(np.prod(xs.shape)) // 8:
        # plateau-heavy (integer-valued / flat-background images)
        host = [to_host_np(xs.with_blocks(
            lambda iz, iy, b, k=k: flags[iz, iy][k])) for k in range(3)]
        del flags
        labels = to_host_np(_extrema_device(xs, valid, offs))
        return postprocess_extrema(
            labels.astype(np.int64), *host, to_host_np(xs),
            find_minima=find_minima, find_maxima=find_maxima,
            minima_threshold=minima_threshold,
            maxima_threshold=maxima_threshold,
            allow_borders=allow_borders, want_label_image=want_label_image)

    # singleton extrema and plateau voxels compacted per block, merged in
    # the single-device raster order
    singles = {k: ([], []) for k, on in (("min", find_minima),
                                        ("max", find_maxima)) if on}
    gathered = []
    for iz, iy, b in xs.cells():
        v = valid.blocks[iz][iy]
        lt, gt, bd, same = flags.pop((iz, iy))
        for kind, (idx, sc) in singles.items():
            z, y, xx, s = _singletons(b, v, lt, gt, same, bd, kind,
                                      t32_min, t32_max, allow_borders)
            idx.append(((z + iz * bz) * ny + y + iy * by) * nx + xx)
            sc.append(s)
        if bool(same.any()):
            g = _plateau_gather(
                halo1(xs, iz, iy, float("nan")), halo1(valid, iz, iy, False),
                *(torch.nn.functional.pad(t, (1,) * 6, value=False)
                  for t in (lt, gt, bd, same)), offs)
            g[0] = g[0] - 1 + np.array([iz * bz, iy * by, 0])
            gathered.append(g)
    if spans:
        # every rank's lists, with the shapes of an empty one where a
        # rank found none
        n_o = len(offs)
        empty = [np.zeros((0, 3), np.int64), np.zeros(0, np.float32)] + [
            np.zeros(0, bool)] * 3 + [np.zeros((0, n_o), bool)]
        gathered = [[D.allgather_concat(np.concatenate(p)) for p in zip(
            *(gathered or [empty]))]]
        if not len(gathered[0][0]):
            gathered = []
        for kind, (idx, sc) in singles.items():
            singles[kind] = ([D.allgather_concat(np.concatenate(idx))],
                             [D.allgather_concat(np.concatenate(sc))])
    plateaus: List[tuple] = []
    if gathered:
        parts = [np.concatenate(p) for p in zip(*gathered)]
        zyx = parts[0]
        srt = np.argsort((zyx[:, 0] * ny + zyx[:, 1]) * nx + zyx[:, 2],
                         kind="stable")
        plateaus = _plateau_reduce(*(p[srt] for p in parts), offs, xs.shape)
    merged = {}
    for kind, (idx, sc) in singles.items():
        idx, sc = np.concatenate(idx), np.concatenate(sc)
        srt = np.argsort(idx, kind="stable")
        merged[kind] = (idx[srt], sc[srt])
    return _assemble(merged, plateaus, xs.shape, find_minima, find_maxima,
                     minima_threshold, maxima_threshold, allow_borders,
                     want_label_image)


def _singletons(x, valid, has_lt, has_gt, has_same, border, kind, t32_min,
                t32_max, allow_borders):
    """The extrema of one kind that are single voxels, compacted on the
    device: host (z, y, x, score) arrays in raster order.  The correctly
    rounded float32 bounds reproduce the float64 comparison of the full
    path."""
    if kind == "min":
        cand = valid & ~has_lt & (x <= _scalar(t32_min, x))
    else:
        cand = valid & ~has_gt & (x >= _scalar(t32_max, x))
    cand &= ~has_same
    if not allow_borders:
        cand &= ~border
    z, y, xx = torch.nonzero(cand, as_tuple=True)
    sc = to_host(x[z, y, xx])
    return tuple(to_host(t, dtype=np.int64) for t in (z, y, xx)) + (sc,)


def _assemble(singles, plateaus, shape, find_minima, find_maxima,
              minima_threshold, maxima_threshold, allow_borders,
              want_label_image) -> "ExtremaResult":
    """The sorted extremum lists (and label image) from the singleton
    extrema, ``{kind: (flat indices ascending, scores)}``, and the
    reduced plateaus (``_plateau_reduce``)."""
    def compact(kind, thr):
        idx, sc = singles[kind]
        nv = np.ones(len(idx), np.int64)
        # the plateau extrema of this kind, merged in raster order
        p_sel = []
        for (ridx, rval, size, p_lt, p_gt, p_bd, _) in plateaus:
            is_ext = (not p_lt) if kind == "min" else (not p_gt)
            if not allow_borders and p_bd:
                is_ext = False
            ok_thr = (rval <= thr) if kind == "min" else (rval >= thr)
            if is_ext and ok_thr:
                p_sel.append((ridx, rval, size))
        if p_sel:
            idx = np.concatenate([idx, [p[0] for p in p_sel]]).astype(
                np.int64)
            sc = np.concatenate([sc, np.asarray([p[1] for p in p_sel],
                                                np.float32)])
            nv = np.concatenate([nv, np.asarray([p[2] for p in p_sel],
                                                np.int64)])
            order = np.argsort(idx, kind="stable")
            idx, sc, nv = idx[order], sc[order], nv[order]
        return idx.astype(np.int64), sc, nv

    zero_i = np.zeros(0, np.int64)
    zero_f = np.zeros(0, np.float32)
    min_idx, min_sc, min_nv = zero_i, zero_f, zero_i
    max_idx, max_sc, max_nv = zero_i, zero_f, zero_i
    if find_minima:
        idx, sc, nv = compact("min", minima_threshold)
        perm = np.lexsort((np.arange(len(idx)), sc))
        min_idx, min_sc, min_nv = idx[perm], sc[perm], nv[perm]
    if find_maxima:
        idx, sc, nv = compact("max", maxima_threshold)
        perm = np.lexsort((-np.arange(len(idx)), -sc))
        max_idx, max_sc, max_nv = idx[perm], sc[perm], nv[perm]
    label_image = None
    if want_label_image:
        members = {p[0]: p[6] for p in plateaus}
        flat = np.zeros(int(np.prod(shape)), np.int64)
        for rank, ridx in enumerate(min_idx):
            flat[members.get(int(ridx), [ridx])] = -(rank + 1)
        for rank, ridx in enumerate(max_idx):
            flat[members.get(int(ridx), [ridx])] = rank + 1
        label_image = flat.reshape(shape)
        if not (find_minima and find_maxima):
            label_image = np.abs(label_image)
    return ExtremaResult(
        minima_indices=min_idx, minima_scores=min_sc, minima_nvoxels=min_nv,
        maxima_indices=max_idx, maxima_scores=max_sc, maxima_nvoxels=max_nv,
        label_image=label_image)


def postprocess_extrema(
    labels: np.ndarray,
    has_lt: np.ndarray,
    has_gt: np.ndarray,
    border: np.ndarray,
    vals: np.ndarray,
    find_minima: bool = True,
    find_maxima: bool = True,
    minima_threshold: float = np.inf,
    maxima_threshold: float = -np.inf,
    allow_borders: bool = True,
    want_label_image: bool = True,
) -> ExtremaResult:
    """Host reduction of per-voxel plateau labels and flags into sorted
    extremum lists."""
    n = vals.size
    flat_labels = labels.reshape(-1)
    in_mask = flat_labels >= 0
    lab = flat_labels[in_mask]
    plateau_has_lt = np.zeros(n, bool)
    plateau_has_gt = np.zeros(n, bool)
    plateau_border = np.zeros(n, bool)
    plateau_size = np.zeros(n, np.int64)
    np.logical_or.at(plateau_has_lt, lab, has_lt.reshape(-1)[in_mask])
    np.logical_or.at(plateau_has_gt, lab, has_gt.reshape(-1)[in_mask])
    np.logical_or.at(plateau_border, lab, border.reshape(-1)[in_mask])
    np.add.at(plateau_size, lab, 1)

    roots = np.unique(lab)
    is_min = ~plateau_has_lt[roots]
    is_max = ~plateau_has_gt[roots]
    if not allow_borders:
        ok = ~plateau_border[roots]
        is_min &= ok
        is_max &= ok
    root_vals = vals.reshape(-1)[roots]

    def build(sel, scores_thresh_ok, descending):
        rr = roots[sel & scores_thresh_ok]
        sc = vals.reshape(-1)[rr]
        nv = plateau_size[rr]
        # discovery order == increasing root (raster) order; ties keep it
        # ascending and reverse it descending, as the reference's sort
        order_key = np.arange(len(rr))
        if descending:
            perm = np.lexsort((-order_key, -sc))
        else:
            perm = np.lexsort((order_key, sc))
        return rr[perm], sc[perm], nv[perm]

    zero = np.zeros(0)
    min_idx = min_sc = min_nv = zero
    max_idx = max_sc = max_nv = zero
    if find_minima:
        min_idx, min_sc, min_nv = build(
            is_min, root_vals <= minima_threshold, descending=False)
    if find_maxima:
        max_idx, max_sc, max_nv = build(
            is_max, root_vals >= maxima_threshold, descending=True)

    label_image = None
    if want_label_image:
        lut = np.zeros(n + 1, np.int64)  # root -> signed rank
        if find_minima:
            lut[min_idx] = -(np.arange(len(min_idx)) + 1)
        if find_maxima:
            lut[max_idx] = np.arange(len(max_idx)) + 1
        label_image = np.where(labels >= 0, lut[np.clip(labels, 0, n)], 0)
        if not (find_minima and find_maxima):
            label_image = np.abs(label_image)

    return ExtremaResult(
        minima_indices=min_idx.astype(np.int64), minima_scores=min_sc,
        minima_nvoxels=min_nv,
        maxima_indices=max_idx.astype(np.int64), maxima_scores=max_sc,
        maxima_nvoxels=max_nv, label_image=label_image)
