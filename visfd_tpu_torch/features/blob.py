"""Scale-free blob detection: DoG scale space, 4-D extremum scan,
non-max suppression, masked discard.

Port of ``visfd_tpu/features/blob.py`` (reference ``BlobDog``
``feature.hpp:53-427``, ``BlobDogD`` ``:446-512``, ``SortBlobs``
``:519-616``, ``DiscardOverlappingBlobs`` ``:720-913``,
``DiscardMaskedBlobs`` ``:924-969``, ``CalcSphereOverlap``
``visfd_utils.hpp:93-119``, ``BlobDogNM``
``feature_variants.hpp:394-580``).

On the device: the per-scale LoG (``ops.filters.apply_log``: four
``blur3`` launches with a mask, two without), the strict 80-neighbour
(x, y, z, sigma) extremum test and the candidate compaction.  The test
takes only comparisons, so it is computed from min/max pools (exactly):
a voxel is a minimum when the smallest of its 80 neighbours is larger
than it, where the smallest is taken over the 3x3x3 boxes of the scales
below and above and the 26 neighbours in its own scale (built from
separable 3-wide minima along x, y and z).  Neighbours out of bounds or
masked out, and NaN values, enter as NaN, which the minimum and maximum
propagate, so they disqualify.  On the card the test and the sign test
are one launch of ``csrc/blob_extremum.cu`` a mid scale, which reads
the three scales and the mask in place and writes a byte a voxel; a
-mesh run's blocks launch it on each z slab's windows with 1-voxel
halos (``parallel.blocks.iter_windows``).  On the CPU the plain twin
``_extremum_codes`` walks those slabs (a tensor is the one block of a
1 x 1 grid).  Only the candidates' coordinates (``torch.nonzero``,
raster order) and scores leave the card, in one copy, never a
volume-sized mask; blocks of a -mesh run merge their lists into raster
order, and over a mesh that spans ranks each scale's lists are
all-gathered before that merge (the flat index is unique, so every rank
holds the one-process list before the threshold and the NMS).  NMS runs
on the host in the native ``visfd_nms`` (no Python fallback).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from visfd_tpu_torch import _cuda_build as cb
from visfd_tpu_torch.ops import filters as F
from visfd_tpu_torch.parallel import distributed as D
from visfd_tpu_torch.parallel.blocks import iter_windows
from visfd_tpu_torch.parallel.mesh import ShardedVolume
from visfd_tpu_torch.utils.progress import Report, span
from visfd_tpu_torch.utils.transfer import to_device, to_host

SORT_DECREASING = "decreasing"
SORT_INCREASING = "increasing"
SORT_DECREASING_MAGNITUDE = "decreasing_magnitude"
SORT_INCREASING_MAGNITUDE = "increasing_magnitude"

# voxels of a block per slab of the extremum test (the twin, and the
# kernel over a -mesh run's blocks)
SLAB_VOXELS = 2 ** 25

# the Report counts of the extremum test's launches and twin slabs
KERNEL_LAUNCHES = "blob extremum: kernel launches"
TWIN_SLABS = "blob extremum: twin slabs"


@dataclasses.dataclass
class BlobList:
    """Columnar blob list; crds are (N, 3) float voxel coords in
    (x, y, z) order."""
    crds: np.ndarray
    diameters: np.ndarray
    scores: np.ndarray

    @classmethod
    def empty(cls):
        return cls(np.zeros((0, 3)), np.zeros(0), np.zeros(0))

    def __len__(self):
        return len(self.scores)

    def take(self, idx) -> "BlobList":
        return BlobList(self.crds[idx], self.diameters[idx],
                        self.scores[idx])


def _min3(a, axis, fn):
    """``fn`` (torch.minimum or torch.maximum) of the three neighbours
    along ``axis`` of a window with one voxel of halo on that axis (the
    result loses the halo)."""
    n = a.shape[axis] - 2
    return fn(fn(a.narrow(axis, 0, n), a.narrow(axis, 1, n)),
              a.narrow(axis, 2, n))


def _extremum_codes(inb, pw, mw, nw, kw):
    """The strict 4-D extremum test of one slab: windows of the scales
    below, at and above (halo 1 on every axis) and of the mask (None:
    no mask).  Returns (is_min, is_max, centre values) of the slab."""
    ok = inb if kw is None else inb & (kw != 0)
    nan = torch.tensor(float("nan"), device=pw.device)
    centre = mw[1:-1, 1:-1, 1:-1]
    out = []
    for fn in (torch.minimum, torch.maximum):
        planes = []
        for w in (pw, mw, nw):
            v = torch.where(ok, w, nan)
            a = _min3(v, 2, fn)          # along x:   (Z+2, Y+2, X)
            b = _min3(a, 1, fn)          # 3x3 in y:  (Z+2, Y, X)
            planes.append((v, a, b))
        box_p = _min3(planes[0][2], 0, fn)
        box_n = _min3(planes[2][2], 0, fn)
        v, a, b = planes[1]
        # the 26 of the scale itself: the 3x3 of the planes above and
        # below, the rows y -+ 1 of its own plane, and x -+ 1 of its row
        ring = fn(fn(b[:-2], b[2:]), fn(a[1:-1, :-2], a[1:-1, 2:]))
        ring = fn(ring, fn(v[1:-1, 1:-1, :-2], v[1:-1, 1:-1, 2:]))
        nb = fn(fn(box_p, box_n), ring)
        out.append(nb > centre if fn is torch.minimum else nb < centre)
    return out[0], out[1], centre


def _extremum_masks(prev, mid, next_, mask):
    """Strict 4-D local extremum test over the 3x3x3x3 neighbourhood
    (80 neighbours; ``feature.hpp:227-308``) of three (Z, Y, X) tensors:
    (is_min, is_max).  Any out-of-bounds, masked or NaN neighbour
    disqualifies; a masked voxel is no extremum."""
    is_min = torch.zeros(mid.shape, dtype=torch.bool, device=mid.device)
    is_max = torch.zeros_like(is_min)
    for _, _, z0, y0, w in iter_windows([prev, mid, next_, mask],
                                        [0.0] * 4, (1, 1, 1), SLAB_VOXELS):
        lo, hi, _ = _extremum_codes(*w)
        is_min[z0:z0 + lo.shape[0]] = lo
        is_max[z0:z0 + hi.shape[0]] = hi
    return is_min, is_max


def _twin_codes(inb, pw, mw, nw, kw):
    """The twin's test AND the sign test of one slab's windows as the
    kernel's codes (uint8: 1 a minimum, 2 a maximum, 0 neither), and the
    slab's centre values."""
    lo, hi, c = _extremum_codes(inb, pw, mw, nw, kw)
    codes = ((lo & (c < 0)).to(torch.uint8)
             | ((hi & (c > 0)).to(torch.uint8) << 1))
    return codes, c


def _extremum_codes_cuda(prev, mid, next_, valid, origin=None, shape=None):
    """The codes of ``_twin_codes`` from one launch of
    ``csrc/blob_extremum.cu`` over three contiguous (Z, Y, X) float32
    CUDA tensors, read in place; ``valid`` is the uint8 ``mask != 0`` of
    their shape, or None (no mask).  With ``origin`` = (z0, y0) and the
    volume's ``shape``, they are a slab's windows with a 1-voxel halo on
    every face (``iter_windows``'s) around the region that starts at
    (z0, y0, 0) of the volume; a halo voxel outside the volume is known
    by its coordinate."""
    vols = [prev, mid, next_] + ([] if valid is None else [valid])
    if any(v.device.type != "cuda" or v.ndim != 3 or v.shape != mid.shape
           for v in vols) or any(v.dtype != torch.float32
                                 for v in vols[:3]) or (
            valid is not None and valid.dtype != torch.uint8):
        got = [(v.dtype, tuple(v.shape), str(v.device)) for v in vols]
        raise ValueError(f"blob extremum kernel: three float32 CUDA volumes "
                         f"and a uint8 mask of one (Z, Y, X) shape, got "
                         f"{got}")
    pad = 0 if origin is None else 1
    oz, oy, ox = (n - 2 * pad for n in mid.shape)
    z0, y0 = (0, 0) if origin is None else origin
    nz, ny = (oz, oy) if shape is None else tuple(shape[-3:-1])
    if mid.shape[1] * mid.shape[2] >= 2 ** 31 or -(-oz // 32) > 65535 \
            or -(-oy // 32) > 65535:
        raise ValueError(f"blob extremum kernel: {tuple(mid.shape)} exceeds "
                         f"its 32-bit plane offsets or its grid")
    codes = torch.empty((oz, oy, ox), dtype=torch.uint8, device=mid.device)
    if codes.numel() == 0:
        return codes
    prev, mid, next_ = (v.contiguous() for v in (prev, mid, next_))
    mask = None if valid is None else valid.contiguous()
    with torch.cuda.device(mid.device):
        cb.check(cb.library().visfd_blob_extremum(
            prev.data_ptr(), mid.data_ptr(), next_.data_ptr(),
            None if mask is None else mask.data_ptr(), codes.data_ptr(),
            oz, oy, ox, pad, z0, y0, nz, ny, cb.stream_of(mid)),
            "visfd_blob_extremum")
    _extremum_codes_cuda.launches += 1
    return codes


_extremum_codes_cuda.launches = 0


def _candidates(codes, centre, z0, y0, report=None):
    """((zyx_min, scores_min), (zyx_max, scores_max)) of a (Z, Y, X) code
    volume on the host, in raster order, (z, y) offset by (z0, y0);
    ``centre`` holds the mid scale's values at the codes' voxels (a view
    will do).  ``torch.nonzero`` waits for the count; the flat indices,
    kinds and scores then come to the host in one copy."""
    flat = torch.nonzero(codes.reshape(-1)).squeeze(1)
    if not len(flat):
        return [(np.zeros((0, 3), np.int64), np.zeros(0, np.float32))] * 2
    _, ny, nx = codes.shape
    z, r = flat // (ny * nx), flat % (ny * nx)
    sc = centre[z, r // nx, r % nx]
    # the kind in the low 2 bits of the flat index; the score's bits
    packed = torch.stack([flat * 4 + codes.reshape(-1)[flat],
                          sc.view(torch.int32).to(torch.int64)])
    host = to_host(packed, report)
    kind = host[0] & 3
    zyx = np.stack(np.unravel_index(host[0] >> 2, codes.shape), axis=1)
    zyx[:, 0] += z0
    zyx[:, 1] += y0
    sc = host[1].astype(np.int32).view(np.float32)
    return [(zyx[kind == k], sc[kind == k]) for k in (1, 2)]


def _tested(prev, mid, next_, mask, card, multi):
    """(z0, y0, codes, centre) of each piece of one scale's test (see
    ``_candidates``), computed as it is drawn.  On the ``card``, a plain
    tensor or a 1 x 1 grid (not ``multi``) is one piece: one kernel
    launch over the whole volume, read in place.  A -mesh run's blocks
    on the card launch the kernel on each z slab's windows; CPU tensors
    run the twin on them."""
    if card and not multi:
        p, m, n, k = (v.blocks[0][0] if isinstance(v, ShardedVolume) else v
                      for v in (prev, mid, next_, mask))
        # made a scale, not held through the ladder, whose blurs are the
        # card's peak
        valid = None if k is None else (k != 0).view(torch.uint8)
        codes = _extremum_codes_cuda(p, m, n, valid)
        del valid
        yield 0, 0, codes, m
        return
    for _, _, z0, y0, w in iter_windows([prev, mid, next_, mask], [0.0] * 4,
                                        (1, 1, 1), SLAB_VOXELS):
        if card:
            kw = w[4]
            codes = _extremum_codes_cuda(
                *w[1:4], None if kw is None else (kw != 0).view(torch.uint8),
                (z0, y0), mid.shape)
            yield z0, y0, codes, w[2][1:-1, 1:-1, 1:-1]
        else:
            yield (z0, y0) + _twin_codes(*w)


def _scale_candidates(prev, mid, next_, mask, report=None):
    """Candidates of one scale: (zyx_min, scores_min), (zyx_max,
    scores_max) as host arrays, the coordinates in raster order: the
    extremum test AND the sign test (minima score < 0, maxima > 0,
    ``feature.hpp:318-341``; ``_tested``), compacted on the device.  A
    ``Report`` gets the spans "blob: extremum test", "blob: compaction
    + copy" and "blob: candidate merge", adds the pieces to the count
    ``KERNEL_LAUNCHES`` (on the card) or ``TWIN_SLABS``, and counts the
    copies to the host."""
    found = ([], []), ([], [])
    multi = isinstance(mid, ShardedVolume) and mid.mesh.shape != (1, 1)
    spans = multi and mid.mesh.spans_processes
    card = (mid.local_block if isinstance(mid, ShardedVolume)
            else mid).device.type == "cuda"
    pieces = _tested(prev, mid, next_, mask, card, multi)
    drawn = 0
    while True:
        with span("blob: extremum test", report):
            try:
                z0, y0, codes, c = next(pieces)
            except StopIteration:
                break
        drawn += 1
        with span("blob: compaction + copy", report):
            for (crds, scores), (zyx, sc) in zip(
                    found, _candidates(codes, c, z0, y0, report)):
                if len(zyx):
                    crds.append(zyx)
                    scores.append(sc)
    if isinstance(report, Report):
        report.add_count(KERNEL_LAUNCHES if card else TWIN_SLABS, drawn)
    out = []
    with span("blob: candidate merge", report):
        for crds, scores in found:
            zyx = (np.concatenate(crds) if crds
                   else np.zeros((0, 3), np.int64))
            sc = (np.concatenate(scores) if scores
                  else np.zeros(0, np.float32))
            if spans:   # every rank's candidates
                zyx, sc = D.allgather_concat(zyx), D.allgather_concat(sc)
            if multi:   # the blocks' lists into raster order
                _, ny, nx = mid.shape
                flat = (zyx[:, 0] * ny + zyx[:, 1]) * nx + zyx[:, 2]
                order = np.argsort(flat, kind="stable")
                zyx, sc = zyx[order], sc[order]
            out.append((zyx, sc))
    return out[0], out[1]


def match_blob_lists(a: BlobList, b: BlobList):
    """(ia, ib, only_a, only_b): indices of the blobs of ``a`` and ``b``
    at the same (x, y, z, diameter), pairwise, and of those in one list
    only (for comparing two runs' lists)."""
    def keys(bl):
        return [tuple(c) + (d,) for c, d in zip(bl.crds.tolist(),
                                                 bl.diameters.tolist())]
    kb = {k: i for i, k in enumerate(keys(b))}
    ia, ib, only_a = [], [], []
    for i, k in enumerate(keys(a)):
        j = kb.pop(k, None)
        if j is None:
            only_a.append(i)
        else:
            ia.append(i)
            ib.append(j)
    return (np.asarray(ia, np.int64), np.asarray(ib, np.int64),
            np.asarray(only_a, np.int64),
            np.asarray(sorted(kb.values()), np.int64))


def extremum_margins(x, sigmas, zyx, scale_index, mask=None,
                     aspect_ratio=(1.0, 1.0, 1.0),
                     delta_sigma_over_sigma: float = 0.02,
                     truncate_ratio: float = 2.5) -> np.ndarray:
    """For candidates at (z, y, x) of ladder scale ``scale_index`` (its
    mid scale, 1 .. len(sigmas) - 2), min |neighbour - centre| / |centre|
    over the 80 neighbours of the extremum test that lie in the volume
    and the mask: how far each is from a tie.  Where it is below the
    rounding of two implementations' LoG values, their lists may differ
    by that candidate (a diagnostic for the checks; ``x`` a tensor)."""
    zyx = np.asarray(zyx, np.int64).reshape(-1, 3)
    scale_index = np.asarray(scale_index, np.int64).reshape(-1)
    out = np.full(len(zyx), np.inf)
    logs = {}

    def log(k):
        if k not in logs:
            sig = tuple(sigmas[k] * a for a in aspect_ratio)
            v = log_filter_for_scale(x, sig, delta_sigma_over_sigma,
                                     truncate_ratio, mask)
            if mask is not None:
                v = torch.where(mask != 0, v, torch.nan)
            logs[k] = torch.nn.functional.pad(v, (1,) * 6, value=torch.nan)
        return logs[k]

    for k in np.unique(scale_index):
        sel = np.flatnonzero(scale_index == k)
        z, y, xx = (torch.as_tensor(zyx[sel, i] + 1) for i in range(3))
        centre = log(int(k))[z, y, xx].double()
        gaps = []
        for j in (k - 1, k, k + 1):
            v = log(int(j))
            for dz in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        if j == k and dz == dy == dx == 0:
                            continue
                        nb = v[z + dz, y + dy, xx + dx].double()
                        gaps.append(torch.nan_to_num(
                            (nb - centre).abs(), nan=torch.inf))
        g = torch.stack(gaps).min(0).values / centre.abs()
        out[sel] = to_host(g)
    return out


def log_filter_for_scale(x, sigma_xyz, delta, truncate_ratio, mask):
    return F.apply_log(x, sigma_xyz, mask=mask,
                       delta_sigma_over_sigma=delta,
                       truncate_ratio=truncate_ratio)


def blob_dog(
    x,
    sigmas: Sequence[float],
    mask=None,
    aspect_ratio: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    delta_sigma_over_sigma: float = 0.02,
    truncate_ratio: float = 2.5,
    minima_threshold: float = np.inf,
    maxima_threshold: float = -np.inf,
    use_threshold_ratios: bool = True,
    report=None,
) -> Tuple[BlobList, BlobList]:
    """Returns (minima, maxima) BlobLists with per-blob sigma stored in
    ``diameters`` (callers converting to diameters use blob_dog_d).
    ``x`` (and ``mask``) may be ShardedVolumes: the same lists, on
    every rank when the mesh spans ranks (each calls it)."""
    if not isinstance(x, ShardedVolume):
        x = torch.as_tensor(x, dtype=torch.float32)
    m = mask
    if m is not None and not isinstance(m, ShardedVolume):
        m = to_device(m, x.device, report, torch.float32)
    sigmas = list(sigmas)

    min_crds, min_sig, min_sc = [], [], []
    max_crds, max_sig, max_sc = [], [], []

    ring = [None, None, None]
    for ir, s in enumerate(sigmas):
        if report:
            report.write(f"--- Progress: {ir+1}/{len(sigmas)}\n"
                         f"--- Applying DoG filter using sigma[{ir}] = {s}"
                         " (in voxels) ---\n")
        sig_xyz = tuple(s * a for a in aspect_ratio)
        ring[ir % 3] = None     # free the oldest scale before the next
        with span("blob: LoG ladder", report):
            ring[ir % 3] = log_filter_for_scale(
                x, sig_xyz, delta_sigma_over_sigma, truncate_ratio, m)
        if ir < 2:
            continue
        prev, mid, next_ = ring[(ir - 2) % 3], ring[(ir - 1) % 3], ring[ir % 3]
        hit_min, hit_max = _scale_candidates(prev, mid, next_, m, report)
        for (zyx, scores), crds, sigl, scl in (
            (hit_min, min_crds, min_sig, min_sc),
            (hit_max, max_crds, max_sig, max_sc),
        ):
            if len(zyx):
                crds.append(zyx[:, ::-1].astype(np.float64))  # (x, y, z)
                sigl.append(np.full(len(zyx), sigmas[ir - 1]))
                scl.append(scores)

    def pack(crds, sigl, scl):
        if not crds:
            return BlobList.empty()
        return BlobList(np.concatenate(crds), np.concatenate(sigl),
                        np.concatenate(scl))

    minima = pack(min_crds, min_sig, min_sc)
    maxima = pack(max_crds, max_sig, max_sc)
    if isinstance(report, Report):
        n = [report.counts.get(k, 0) for k in (KERNEL_LAUNCHES, TWIN_SLABS)]
        report.line(f"{KERNEL_LAUNCHES}: {n[0]}; {TWIN_SLABS}: {n[1]}")

    # final threshold filter (feature.hpp:362-417)
    if np.isfinite(minima_threshold) or np.isfinite(maxima_threshold) \
       or use_threshold_ratios:
        mt, xt = minima_threshold, maxima_threshold
        if use_threshold_ratios:
            gmin = minima.scores.min() if len(minima) else 1.0
            gmax = maxima.scores.max() if len(maxima) else -1.0
            mt = minima_threshold * gmin
            xt = maxima_threshold * gmax
        if np.isfinite(mt) and len(minima):
            minima = minima.take(minima.scores <= mt)
        if np.isfinite(xt) and len(maxima):
            maxima = maxima.take(maxima.scores >= xt)
    return minima, maxima


def blob_dog_d(
    x,
    diameters: Sequence[float],
    mask=None,
    **kw,
) -> Tuple[BlobList, BlobList]:
    """Diameter interface: sigma = d / (2*sqrt(3)) (``feature.hpp:
    446-512``).  Returned ``diameters`` columns are real diameters."""
    conv = 2.0 * np.sqrt(3.0)
    minima, maxima = blob_dog(x, [d / conv for d in diameters], mask=mask,
                              **kw)
    minima.diameters = minima.diameters * conv
    maxima.diameters = maxima.diameters * conv
    return minima, maxima


def sort_blobs(
    blobs: BlobList,
    criteria: str = SORT_DECREASING_MAGNITUDE,
    ascending_order: bool = True,
) -> BlobList:
    """Stable sort with the reference's tuple semantics
    (``feature.hpp:519-616``): key is score (or |score|), ties keep
    original order ascending / reversed order descending."""
    if criteria in (SORT_DECREASING_MAGNITUDE, SORT_INCREASING_MAGNITUDE):
        key = np.abs(blobs.scores)
    else:
        key = blobs.scores
    ascending = ascending_order
    if criteria in (SORT_INCREASING, SORT_INCREASING_MAGNITUDE):
        ascending = not ascending
    idx = np.arange(len(blobs))
    if ascending:
        perm = np.lexsort((idx, key))
    else:
        perm = np.lexsort((-idx, -key))
    return blobs.take(perm)


def calc_sphere_overlap(rij, ri, rj):
    """Lens volume of two intersecting spheres
    (``visfd_utils.hpp:93-119``)."""
    if ri > rj:
        ri, rj = rj, ri
    if rij <= ri:
        return (4 * np.pi / 3) * ri ** 3
    xi = 0.5 / rij * (rij * rij + ri * ri - rj * rj)
    xj = 0.5 / rij * (rij * rij + rj * rj - ri * ri)
    return (np.pi / 3) * (
        ri ** 3 * (2 - (xi / ri) * (3 - (xi / ri) ** 2))
        + rj ** 3 * (2 - (xj / rj) * (3 - (xj / rj) ** 2)))


def discard_overlapping_blobs(
    blobs: BlobList,
    min_radial_separation_ratio: float,
    max_volume_overlap_large: float = np.inf,
    max_volume_overlap_small: float = np.inf,
    criteria: str = SORT_DECREASING_MAGNITUDE,
    scale: int = 6,
) -> BlobList:
    """Greedy best-first NMS through a coarse occupancy grid,
    replicating ``DiscardOverlappingBlobs`` (``feature.hpp:720-913``)
    including its grid-limited collision detection; the sequential scan
    runs in the native ``visfd_nms`` (raises if it cannot be built)."""
    import ctypes

    from visfd_tpu_torch import native

    blobs = sort_blobs(blobs, criteria, ascending_order=False)
    n = len(blobs)
    if n == 0:
        return blobs

    # bounds are ints in the reference (truncation toward zero on
    # assignment, feature.hpp:765-777); kept so the grid geometry matches
    reff_all = np.ceil(blobs.diameters / 2)
    lo_all = (blobs.crds - reff_all[:, None]).astype(np.int64)  # trunc
    hi_all = (blobs.crds + reff_all[:, None]).astype(np.int64)
    bounds_min = lo_all.min(axis=0)
    bounds_max = hi_all.max(axis=0)
    table_size = (1 + bounds_max - bounds_min) // scale

    radii = blobs.diameters / 2
    vols = (4 * np.pi / 3) * radii ** 3
    grid = np.floor((blobs.crds - bounds_min) / scale).astype(np.int64)

    lib = native.load()
    crds_c = np.ascontiguousarray(blobs.crds, np.float64)
    radii_c = np.ascontiguousarray(radii, np.float64)
    vols_c = np.ascontiguousarray(vols, np.float64)
    grid_c = np.ascontiguousarray(grid, np.int64)
    tsz_c = np.ascontiguousarray(table_size, np.int64)
    keep_c = np.zeros(n, np.uint8)
    lib.visfd_nms(
        native.ptr(crds_c, ctypes.c_double),
        native.ptr(radii_c, ctypes.c_double),
        native.ptr(vols_c, ctypes.c_double),
        native.ptr(grid_c, ctypes.c_int64),
        native.ptr(tsz_c, ctypes.c_int64),
        n, int(scale),
        float(min_radial_separation_ratio),
        float(max_volume_overlap_small),
        float(max_volume_overlap_large),
        native.ptr(keep_c, ctypes.c_uint8))
    return blobs.take(np.flatnonzero(keep_c))


def discard_masked_blobs(blobs: BlobList, mask: np.ndarray) -> BlobList:
    """Drop blobs whose (rounded) centres fall where mask == 0
    (``feature.hpp:924-969``)."""
    if mask is None or len(blobs) == 0:
        return blobs
    mask = np.asarray(mask)
    ix = np.floor(blobs.crds[:, 0] + 0.5).astype(int)
    iy = np.floor(blobs.crds[:, 1] + 0.5).astype(int)
    iz = np.floor(blobs.crds[:, 2] + 0.5).astype(int)
    keep = mask[iz, iy, ix] != 0
    return blobs.take(keep)


def blob_dog_nm(
    x,
    diameters: Sequence[float],
    mask=None,
    aspect_ratio=(1.0, 1.0, 1.0),
    delta_sigma_over_sigma: float = 0.02,
    truncate_ratio: float = 2.5,
    truncate_threshold: Optional[float] = None,
    minima_threshold: float = 0.5,
    maxima_threshold: float = 0.5,
    use_threshold_ratios: bool = True,
    sep_ratio_thresh: float = 1.0,
    nonmax_max_overlap_large: float = 1.0,
    nonmax_max_overlap_small: float = 1.0,
    report=None,
) -> Tuple[BlobList, BlobList]:
    """Blob detection + NMS composition
    (``feature_variants.hpp:394-580``).  ``truncate_threshold`` (if
    given and truncate_ratio <= 0) converts a kernel-decay cutoff into a
    ratio: ratio = sqrt(-2 ln thresh)."""
    if truncate_ratio <= 0:
        if not (truncate_threshold and truncate_threshold > 0):
            raise ValueError("blob_dog_nm: a truncation ratio or a "
                             "positive truncation threshold is needed")
        truncate_ratio = float(np.sqrt(-2.0 * np.log(truncate_threshold)))
    minima, maxima = blob_dog_d(
        x, diameters, mask=mask, aspect_ratio=aspect_ratio,
        delta_sigma_over_sigma=delta_sigma_over_sigma,
        truncate_ratio=truncate_ratio,
        minima_threshold=minima_threshold,
        maxima_threshold=maxima_threshold,
        use_threshold_ratios=use_threshold_ratios,
        report=report)
    do_nms = (sep_ratio_thresh > 0.0 or nonmax_max_overlap_small < 1.0
              or nonmax_max_overlap_large < 1.0)
    if not do_nms:
        return minima, maxima
    with span("blob: NMS", report):
        minima = discard_overlapping_blobs(
            minima, sep_ratio_thresh, nonmax_max_overlap_large,
            nonmax_max_overlap_small, SORT_INCREASING)
        maxima = discard_overlapping_blobs(
            maxima, sep_ratio_thresh, nonmax_max_overlap_large,
            nonmax_max_overlap_small, SORT_DECREASING)
    return minima, maxima
