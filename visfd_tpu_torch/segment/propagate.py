"""Device-scale watershed by iterative label propagation, in torch.

Port of ``visfd_tpu/segment/propagate.py``: a steepest-descent watershed
computed with fixpoint label propagation on the volume's device (no host
copy of the volume), for volumes the host Meyer flood
(``segment.watershed``) is too serial for.

1. per voxel the steepest lower neighbour (lowest value, ties to the
   smallest flat index);
2. plateau components of equal-valued neighbours, labelled by their
   smallest flat index, with whether any member has a lower neighbour;
3. minimum plateaus become basin roots (each member points at the
   plateau's representative); the other plateau members without a lower
   neighbour adopt a resolved equal neighbour (BFS from the exits);
4. pointer jumping collapses the parents to roots.

Basins are numbered 1..N by score (ascending on the flood's surface),
raster order on ties, as the host flood numbers them.  ``markers`` seed
a minimax flooding-level propagation (``_minimax_device``); Meyer
boundaries come from ``meyer_boundaries``: the contested voxels are found
on the device and only they cross to the host for the ordered cascade.

Every stage walks the (z, y) blocks of a ``parallel.mesh.ShardedVolume``
and reads its neighbours through a 1-voxel halo (``parallel.halo.halo1``);
a plain tensor runs as the one block of a 1 x 1 grid.  So the mesh form
(``parallel.sharded_features.propagate_watershed_sharded``) is this code
on more blocks, and its labels equal the single-device ones.  Plateau
labels jump along pointers inside a block (the JAX package's sharded
scheme); the final root jump gathers the parents on the first block's
device (``parallel.gather.gather_on_device``).  Each ``while_loop`` of
the JAX package is a Python loop (``parallel.blocks.fixpoint``) whose
"changed" flag is read every few iterations: past its fixpoint an
iteration changes nothing, and ``_minimax_device`` still stops at its cap of 8
(nz + ny + nx) iterations exactly.  Flat indices are int32, as in the JAX package; a
volume of 2^31 - 1 voxels or more is refused.

Over a mesh that spans ranks (``parallel.distributed``) each loop
receives its 1-voxel halos through ``parallel.halo.with_ghosts`` every
round and reduces its flags over the ranks; the root jump all-gathers
the parents (every rank jumps the whole volume on its own card, as XLA
does over the JAX package's global mesh); the basin roots and the
contested voxels are all-gathered and merged on their global raster
indices, and ``gather_flat`` merges the roots' scores.  So every rank
numbers the basins and runs the Meyer cascade on the one-process lists,
and its blocks' labels equal the one-process ones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from visfd_tpu_torch.parallel import distributed as D
from visfd_tpu_torch.parallel.blocks import (
    INF, SENT, Geom, cells, fixpoint, nb)
from visfd_tpu_torch.parallel.gather import gather_on_device, to_host_np
from visfd_tpu_torch.parallel.halo import halo1, with_ghosts
from visfd_tpu_torch.parallel.mesh import (
    ShardedVolume, as_blocks, bmap, gather_flat, place, scatter_flat, unwrap)
from visfd_tpu_torch.segment.extrema import neighbor_offsets
from visfd_tpu_torch.utils.progress import Report
from visfd_tpu_torch.utils.transfer import to_device, to_host


def _merged(vol: ShardedVolume, a: np.ndarray) -> np.ndarray:
    """``a``, this rank's part of a host list, joined with every other
    rank's (in rank order) when ``vol`` spans ranks."""
    return D.allgather_concat(a) if vol.mesh.spans_processes else a


def _padded(vol: ShardedVolume, fill) -> dict:
    """{(iz, iy): block padded by one voxel (``halo1``)} for this rank's
    blocks, the rows of other ranks' blocks received first."""
    g = with_ghosts(vol, 1, 1)
    return {(iz, iy): halo1(g, iz, iy, fill) for iz, iy, _ in vol.cells()}


def _inputs(x, mask):
    """(x, mask != 0) as blocks: a ShardedVolume as it is, a tensor (or
    numpy array) as the one block of a 1 x 1 grid on its device."""
    xs = x if isinstance(x, ShardedVolume) else as_blocks(
        torch.as_tensor(x, dtype=torch.float32))
    if mask is None:
        return xs, xs.with_blocks(lambda iz, iy, b: torch.ones_like(
            b, dtype=torch.bool))
    m = mask if isinstance(mask, ShardedVolume) else as_blocks(
        to_device(mask, xs.local_block.device))
    return xs, bmap(lambda t: t != 0, m)


def _descend_device(x, mask, offsets, rep: Optional[Report] = None):
    """(root, valid): per voxel the flat index of its basin root (its
    steepest-descent destination; -1 outside the mask) and the in-mask
    predicate.  ``x`` and ``mask`` are tensors or ShardedVolumes."""
    rep = rep if rep is not None else Report(None)
    xs, valid = _inputs(x, mask)
    g = Geom(xs)
    xv = bmap(lambda a, v: torch.where(v, a, INF), xs, valid)
    xv_p = _padded(xv, INF)

    def same(iz, iy, off):
        p = xv_p[iz, iy]
        return g.inb(iz, iy, off, p.device) & (nb(p, off) == nb(
            p, (0, 0, 0)))

    # -- 1. steepest lower neighbour (min value, tie -> min index) --
    has_lower, best_idx = {}, {}
    for iz, iy, b in xv.cells():
        idx = g.idx(iz, iy, b.device)
        best_v = torch.full_like(b, INF)
        best_i = torch.full_like(idx, SENT)
        for off in offsets:
            nv = nb(xv_p[iz, iy], off)
            nidx = idx + g.delta(off)
            lower = g.inb(iz, iy, off, b.device) & (nv < b)
            better = lower & ((nv < best_v)
                              | ((nv == best_v) & (nidx < best_i)))
            best_v = torch.where(better, nv, best_v)
            best_i = torch.where(better, nidx, best_i)
        has_lower[iz, iy] = torch.isfinite(best_v)
        best_idx[iz, iy] = best_i

    # -- 2. plateau labels (min flat index of each equal-valued
    #       component) and whether the plateau has a lower neighbour
    #       (min-propagated key), with block-local pointer jumps --
    def plab_step(state):
        lab, key = state
        flags = []
        lab_g, key_g = with_ghosts(lab, 1, 1), with_ghosts(key, 1, 1)

        def cell(iz, iy):
            lp, kp = halo1(lab_g, iz, iy, SENT), halo1(key_g, iz, iy, SENT)
            l0, k0 = lab.blocks[iz][iy], key.blocks[iz][iy]
            nl, nk = l0, k0
            for off in offsets:
                s = same(iz, iy, off)
                nl = torch.where(s, torch.minimum(nl, nb(lp, off)), nl)
                nk = torch.where(s, torch.minimum(nk, nb(kp, off)), nk)
            inblk, (jl, jk) = g.jump(iz, iy, nl, nk)
            nl = torch.where(inblk, jl, nl)
            nk = torch.where(inblk, torch.minimum(nk, jk), nk)
            flags.append(((nl != l0) | (nk != k0)).any())
            return nl, nk
        new = {(iz, iy): cell(iz, iy) for iz, iy, _ in lab.cells()}
        return ((lab.with_blocks(lambda iz, iy, _: new[iz, iy][0]),
                 key.with_blocks(lambda iz, iy, _: new[iz, iy][1])), flags)

    idx0 = xv.with_blocks(lambda iz, iy, b: g.idx(iz, iy, b.device))
    key0 = idx0.with_blocks(lambda iz, iy, i: torch.where(
        has_lower[iz, iy] & valid.blocks[iz][iy], i, SENT))
    (plab, pkey), n_plab = fixpoint(plab_step, (idx0, key0))
    rep.record_count("watershed-device: plateau label rounds", n_plab)

    # -- 3. initial parents; plateau members without a lower neighbour
    #       adopt a resolved equal neighbour (BFS from the exits) --
    def parent0(iz, iy, i):
        v = valid.blocks[iz][iy]
        is_min = v & (pkey.blocks[iz][iy] == SENT)
        par = torch.where(has_lower[iz, iy], best_idx[iz, iy], -1)
        par = torch.where(is_min, plab.blocks[iz][iy], par)
        return torch.where(~v, i, par)
    parent = idx0.with_blocks(parent0)
    del plab, pkey, best_idx

    def resolve_step(par):
        flags = []
        par_g = with_ghosts(par, 1, 1)

        def cell(iz, iy, p0):
            pp = halo1(par_g, iz, iy, -1)
            idx = idx0.blocks[iz][iy]
            resolved = p0 >= 0
            newpar = p0
            for off in offsets:
                cand_ok = same(iz, iy, off) & (nb(pp, off) >= 0)
                cand = torch.where(cand_ok, idx + g.delta(off), SENT)
                newpar = torch.where(
                    ~resolved & cand_ok
                    & (cand < torch.where(newpar >= 0, newpar, SENT)),
                    cand, newpar)
            flags.append(((newpar >= 0) != resolved).any())
            return newpar
        return par.with_blocks(cell), flags

    parent, n_res = fixpoint(resolve_step, parent)
    rep.record_count("watershed-device: plateau resolve rounds", n_res)
    parent = bmap(lambda p, i: torch.where(p < 0, i, p), parent, idx0)
    del xv_p, idx0

    # -- 4. pointer jumping to the roots, over the whole volume on the
    #       first local block's device (every rank's parents gathered) --
    flat = gather_on_device(parent, parent.local_block.device,
                            kind="pointer jump").reshape(-1)
    del parent

    def jump_step(p):
        new = p[p]
        return new, [(new != p).any()]
    flat, n_jump = fixpoint(jump_step, flat)
    rep.record_count("watershed-device: pointer jump rounds", n_jump)
    flat = flat.reshape(g.shape)
    root = valid.with_blocks(lambda iz, iy, v: torch.where(
        v, flat[iz * g.bz:(iz + 1) * g.bz, iy * g.by:(iy + 1) * g.by].to(
            v.device), -1))
    return unwrap(root, x), unwrap(valid, x)


def _minimax_device(x, seed_lab, mask, offsets,
                    rep: Optional[Report] = None):
    """Flooding level r(v) (the level at which the Meyer flood pops v)
    and the flood label, by fixpoint propagation: donor(v) is the
    neighbour u minimising (r_u, x_u), label(v) = label(donor), r(v) =
    max(r_donor, x_v); seeds are pinned.  Exact Meyer parity wherever
    intensities are distinct.  Returns (r, labels) like ``x``."""
    rep = rep if rep is not None else Report(None)
    xs, valid = _inputs(x, mask)
    seeds = seed_lab if isinstance(seed_lab, ShardedVolume) \
        else (place(np.asarray(seed_lab, np.int32), xs)
              if isinstance(seed_lab, np.ndarray)
              else as_blocks(seed_lab.to(torch.int32)))
    g = Geom(xs)
    xv = bmap(lambda a, v: torch.where(v, a, INF), xs, valid)
    xv_p = _padded(xv, INF)
    is_seed = bmap(lambda s, v: (s > 0) & v, seeds, valid)
    state = (bmap(lambda s, a: torch.where(s, a, INF), is_seed, xv),
             bmap(lambda s, lab: torch.where(s, lab.to(torch.int32), SENT),
                  is_seed, seeds),
             bmap(lambda s: torch.where(s, -INF, INF), is_seed),
             bmap(lambda s: torch.where(s, -INF, INF), is_seed))

    def step(st):
        r, lab, dr, dx = st
        flags = []
        r_g, lab_g = with_ghosts(r, 1, 1), with_ghosts(lab, 1, 1)

        def cell(iz, iy):
            rp, lp = halo1(r_g, iz, iy, INF), halo1(lab_g, iz, iy, SENT)
            xb, v, s = (xv.blocks[iz][iy], valid.blocks[iz][iy],
                        is_seed.blocks[iz][iy])
            r0, l0, dr0, dx0 = (t.blocks[iz][iy] for t in st)
            free = v & ~s
            nr, nl, ndr, ndx = r0, l0, dr0, dx0
            for off in offsets:
                r_u, x_u, l_u = (nb(rp, off), nb(xv_p[iz, iy], off),
                                 nb(lp, off))
                ok = free & (l_u != SENT)
                better = ok & ((r_u < ndr) | ((r_u == ndr) & (x_u < ndx)))
                relabel = ok & (r_u == ndr) & (x_u == ndx) & (l_u != nl)
                ndr = torch.where(better, r_u, ndr)
                ndx = torch.where(better, x_u, ndx)
                nl = torch.where(better | relabel, l_u, nl)
                nr = torch.where(better, torch.maximum(r_u, xb), nr)
            flags.append(((ndr != dr0) | (ndx != dx0) | (nl != l0)).any())
            return nr, nl, ndr, ndx
        new = {(iz, iy): cell(iz, iy) for iz, iy, _ in r.cells()}
        return tuple(r.with_blocks(lambda iz, iy, _, j=j: new[iz, iy][j])
                     for j in range(4)), flags

    # the cap: relabels along pathological equal-r donor cycles (exact
    # fp ties only) must not livelock
    max_it = 8 * int(sum(g.shape))
    (r, lab, _, _), n_it = fixpoint(step, state, max_it)
    rep.record_count("watershed-device: minimax rounds", n_it)
    return (unwrap(r, x),
            unwrap(bmap(lambda t: torch.where(t == SENT, 0, t), lab), x))


def meyer_boundaries(labels, r, x_signed, offs, valid=None,
                     label_boundary: int = 0):
    """Post-pass reproducing the Meyer flood's boundary labelling
    (``segmentation.hpp:449-465``): a popped voxel that touches an
    already-assigned different basin becomes the boundary.  Pop order is
    (flooding level r, intensity, flat index), exact wherever
    intensities are distinct.  The contested voxels (assigned, beside a
    differently-labelled assigned voxel) are found on the device, and
    only their indices, keys and neighbour flags cross to the host,
    where the cascade runs in vectorised rounds over dependency ranks,
    then the same sequential tail as the JAX package.  Returns new
    labels like ``labels``."""
    lab = as_blocks(labels)
    rs, xs = as_blocks(r), as_blocks(x_signed)
    g = Geom(lab)
    _, ny, nx = g.shape
    assigned = bmap(lambda t, m: (t > 0) & m, lab, _inputs(lab, valid)[1])
    lab_g, asg_g = with_ghosts(lab, 1, 1), with_ghosts(assigned, 1, 1)
    flat, rf, xf, dep = [], [], [], []
    for iz, iy, lb, ab, rb, xb in cells(lab, assigned, rs, xs):
        lp, ap = halo1(lab_g, iz, iy, -2), halo1(asg_g, iz, iy, False)
        deps = [ab & nb(ap, off) & (nb(lp, off) != lb) for off in offs]
        contested = torch.stack(deps).any(0)
        z, y, xx = torch.nonzero(contested, as_tuple=True)
        flat.append(to_host(((z + iz * g.bz) * ny + y + iy * g.by) * nx + xx))
        rf.append(to_host(rb[z, y, xx]))
        xf.append(to_host(xb[z, y, xx]))
        dep.append(to_host(torch.stack([d[z, y, xx] for d in deps], -1)))
    del lab_g, asg_g
    out = bmap(torch.clone, lab)
    # the blocks' (and the ranks') lists, merged on the global index
    cf, rf, xf, dep = (_merged(lab, np.concatenate(a))
                       for a in (flat, rf, xf, dep))
    m = len(cf)
    if m == 0:
        return unwrap(out, labels)
    srt = np.argsort(cf, kind="stable")
    cf, rf, xf, dep = cf[srt], rf[srt], xf[srt], dep[srt].T
    # pop order: (r, x, flat index); rank of each contested voxel
    pos = np.lexsort((cf, xf, rf))
    order = cf[pos]
    rank = np.empty(m, np.int64)
    rank[pos] = np.arange(m)

    # v becomes boundary iff some neighbour u (assigned, another label,
    # popped strictly earlier) survived.  Every such u is contested (the
    # offsets are symmetric), so its rank comes from the contested list.
    dep_rank = np.full((len(offs), m), -1, np.int64)
    for o, off in enumerate(offs):
        ok = dep[o, pos]
        u = order + g.delta(off)
        j = np.clip(np.searchsorted(cf, u), 0, m - 1)
        ru = rank[j]
        ok &= ru < np.arange(m)
        dep_rank[o] = np.where(ok, ru, -1)
    dr_safe = np.where(dep_rank >= 0, dep_rank, 0)

    status = np.zeros(m, np.int8)   # 0 unknown / 1 boundary / 2 clear
    for _ in range(min(m, 256)):
        unknown = status == 0
        if not unknown.any():
            break
        ds = status[dr_safe]
        any_clear = ((dep_rank >= 0) & (ds == 2)).any(axis=0)
        all_bound = ((dep_rank < 0) | (ds == 1)).all(axis=0)
        newly_b = unknown & any_clear
        newly_c = unknown & ~any_clear & all_bound
        if not (newly_b.any() or newly_c.any()):
            break
        status[newly_b] = 1
        status[newly_c] = 2
    boundary = status == 1
    # sequential tail (rare): the deps of every remaining unknown are
    # decided or earlier in this ascending walk
    for k in np.flatnonzero(status == 0):
        for o in range(len(offs)):
            if dep_rank[o, k] >= 0 and not boundary[dep_rank[o, k]]:
                boundary[k] = True
                break
    scatter_flat(out, order[boundary], label_boundary)
    return unwrap(out, labels)


@dataclasses.dataclass
class PropagateResult:
    labels: object               # (Z, Y, X) int64 tensor (or ShardedVolume)
    num_basins: int
    basin_locations: np.ndarray  # (N, 3) (ix, iy, iz) of the basin roots
    basin_scores: np.ndarray


def _xyz(flat, shape):
    _, ny, nx = shape
    flat = np.asarray(flat, np.int64)
    return np.stack([flat % nx, (flat // nx) % ny, flat // (nx * ny)],
                    -1).reshape(-1, 3)


def postprocess_basins(root, valid, x_signed, start_from_minima: bool,
                       halt: float, label_undefined: int) -> PropagateResult:
    """Basin numbering shared by the single-device and the sharded
    descent: score ascending on the (sign-flipped) flood surface, raster
    order on ties.  The labels come from a binary search of each voxel's
    root in the sorted roots, on the device: no volume-sized table."""
    rs, vs, xs = as_blocks(root), as_blocks(valid), as_blocks(x_signed)
    roots = np.unique(_merged(rs, np.concatenate(
        [to_host(torch.unique(r[v]), dtype=np.int64)
         for _, _, r, v in cells(rs, vs)] + [np.zeros(0, np.int64)])))
    scores = (gather_flat(xs, roots) if len(roots)
              else np.zeros(0, np.float32))
    perm = np.lexsort((roots, scores))
    number = np.empty(len(roots), np.int64)
    number[perm] = np.arange(1, len(roots) + 1)

    def label(iz, iy, r):
        v, xb = vs.blocks[iz][iy], xs.blocks[iz][iy]
        if not len(roots):
            return torch.full(r.shape, label_undefined, dtype=torch.int64,
                              device=r.device)
        rt = torch.as_tensor(roots, device=r.device)
        pos = torch.searchsorted(rt, r.to(torch.int64)).clamp(
            max=len(roots) - 1)
        out = torch.where(v, torch.as_tensor(number, device=r.device)[pos],
                          label_undefined)
        if np.isfinite(halt):
            out = torch.where(v & (xb > halt), label_undefined, out)
        return out
    labels = rs.with_blocks(label)
    roots, scores = roots[perm], scores[perm]
    sign = 1.0 if start_from_minima else -1.0
    return PropagateResult(
        labels=unwrap(labels, root), num_basins=len(roots),
        basin_locations=_xyz(roots, rs.shape),
        basin_scores=(scores * sign).astype(np.float32))


def _marker_watershed(x_signed, mask, markers, offs, start_from_minima,
                      halt, label_undefined,
                      rep: Optional[Report] = None) -> PropagateResult:
    """Marker-seeded device watershed: one seed per positive marker label
    (its first raster voxel in the mask, as ``segment.watershed``),
    labels from the minimax flooding-level propagation, basin ids mapped
    back to the marker labels through a table over the labels."""
    xs, valid = _inputs(x_signed, mask)
    markers = np.asarray(markers)
    valid_np = to_host_np(valid)
    flat = markers.reshape(-1)
    hit = np.flatnonzero((flat > 0) & valid_np.reshape(-1))
    uniq, first = np.unique(flat[hit], return_index=True)
    disc = np.argsort(first, kind="stable")   # discovery (raster) order
    seed_flat = hit[first[disc]]
    marker_labels = uniq[disc].astype(np.int64)
    seeds = xs.with_blocks(lambda iz, iy, b: torch.zeros(
        b.shape, dtype=torch.int32, device=b.device))
    scatter_flat(seeds, seed_flat, np.arange(1, len(seed_flat) + 1))
    _, lab = _minimax_device(xs, seeds, valid, offs, rep)
    lut = np.zeros(len(seed_flat) + 1, np.int64)
    lut[1:] = marker_labels

    def label(iz, iy, lb):
        v, xb = valid.blocks[iz][iy], xs.blocks[iz][iy]
        out = torch.where(v & (lb > 0), lb.to(torch.int64), label_undefined)
        if np.isfinite(halt):
            out = torch.where(v & (xb > halt), label_undefined, out)
        t = torch.as_tensor(lut, device=lb.device)
        return torch.where(out > 0, t[out.clamp(0, len(lut) - 1)], out)
    labels = lab.with_blocks(label)
    sign = 1.0 if start_from_minima else -1.0
    scores = (gather_flat(xs, seed_flat) if len(seed_flat)
              else np.zeros(0, np.float32))
    return PropagateResult(
        labels=unwrap(labels, x_signed), num_basins=len(seed_flat),
        basin_locations=_xyz(seed_flat, xs.shape),
        basin_scores=(scores * sign).astype(np.float32))


def propagate_watershed(
    source,
    mask=None,
    markers=None,
    start_from_minima: bool = True,
    halt_threshold: float = np.inf,
    connectivity: int = 1,
    show_boundaries: bool = False,
    label_boundary: int = 0,
    label_undefined: int = -1,
    report: Optional[Report] = None,
) -> PropagateResult:
    """Device watershed (module docstring) of ``source``, a tensor (on
    its device), a numpy array (on the CPU) or a ShardedVolume (on its
    blocks).  ``markers`` (host array): a label image whose first-seen
    voxel per positive label seeds a basin.  ``show_boundaries``: the
    Meyer flood's basin-collision boundaries (``meyer_boundaries``).
    ``labels`` of the result take the form of ``source`` (int64).  Over
    a mesh that spans ranks every rank calls it; each gets the
    one-process result, labels for its own blocks."""
    x = source if isinstance(source, ShardedVolume) else \
        torch.as_tensor(source, dtype=torch.float32)
    if not start_from_minima:
        x = bmap(torch.neg, x)
        halt = -halt_threshold if np.isfinite(halt_threshold) else np.inf
    else:
        halt = halt_threshold
    offs = neighbor_offsets(connectivity)
    xs, m = _inputs(x, mask)
    if markers is not None:
        res = _marker_watershed(xs, m, markers, offs, start_from_minima,
                                halt, label_undefined, report)
    else:
        root, valid = _descend_device(xs, m, offs, report)
        res = postprocess_basins(root, valid, xs,
                                 start_from_minima=start_from_minima,
                                 halt=halt, label_undefined=label_undefined)
    if show_boundaries:
        seeds = xs.with_blocks(lambda iz, iy, b: torch.zeros(
            b.shape, dtype=torch.int32, device=b.device))
        locs = res.basin_locations
        _, ny, nx = xs.shape
        scatter_flat(seeds, (locs[:, 2] * ny + locs[:, 1]) * nx + locs[:, 0],
                     np.arange(1, len(locs) + 1))
        r, _ = _minimax_device(xs, seeds, m, offs, report)
        res = dataclasses.replace(res, labels=meyer_boundaries(
            res.labels, r, xs, offs, valid=m, label_boundary=label_boundary))
    return dataclasses.replace(res, labels=unwrap(as_blocks(res.labels),
                                                  source))
