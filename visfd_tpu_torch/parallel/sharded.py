"""Sharded voxel pipelines: the per-shard kernels with halo exchange.

Port of ``visfd_tpu/parallel/sharded.py``.  The volume
is a ``ShardedVolume`` of (z, y) blocks (``parallel.mesh``); every
stencil stage copies its halo rows from the neighbouring blocks
(``parallel.halo``, outside the kernels) and runs the per-shard CUDA
kernel on each haloed block, on the block's device.  Per voxel each
kernel then sums the same terms in the same order as on one device, so
the sharded results equal the single-device ones bit for bit on the
card.

* ``separable_conv3d_sharded``: the blur (what GSPMD makes of the JAX
  package's blur on a sharded volume; its hand-written form is
  ``_sharded_gauss``): ``blur3`` on each haloed block, the interior
  kept, the edge normalisation from the global 1-D denominators.
* ``hessian_principal_sharded``: the per-shard Hessian + eigensolve
  kernel on each block in place, its 1-deep halos in four face-sized
  slabs, the global faces clamped afterwards.
* ``tv_accumulate_sharded``: hw-deep halos of saliency, direction and
  mask, the per-shard voting kernel (dense or sparse).
* ``sym3_score_sharded``: the vote-tensor eigen kernel on each block
  (voxelwise: no halo), with the principal vector under ``-connect``;
* ``gradient_sharded``: the FD gradient of ``-edge``, each block read
  with a 2-deep halo (``features.hessian.fd_slab``);
* ``make_membrane_step``: the JAX package's flagship step composed from
  the stages above (blur, Hessian, threshold, voting, stick score).

Each stage walks the blocks of its own rank; over a mesh that spans
ranks the halo rows of other ranks' blocks come through
``parallel.halo.with_ghosts``, so every rank runs every stage.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from visfd_tpu_torch.features.hessian import fd_slab, gradient_fd_padded
from visfd_tpu_torch.ops import kernels as K
from visfd_tpu_torch.ops.blur_cuda import blur3
from visfd_tpu_torch.ops.conv import _ones_denom_1d
from visfd_tpu_torch.ops.eigen_cuda import (
    _n_score_channels, hessian_principal_block, sym3_score)
from visfd_tpu_torch.ops.tv_cuda import tv_tables, tv_votes_prepadded
from visfd_tpu_torch.parallel.halo import (
    _rows, face_halos, halo_pad_2d, haloed_block, with_ghosts)
from visfd_tpu_torch.parallel.mesh import (
    Mesh, ShardedVolume, bmap, from_blocks, shard)


def grid_mesh_of(x) -> Optional[Mesh]:
    """The mesh of a volume split into plain (z, y) blocks, or None for
    anything else (the counterpart of ``features.tv._grid_mesh_of``;
    ``parallel.mesh.shard`` makes even blocks only)."""
    if isinstance(x, ShardedVolume) and x.halo == (0, 0):
        return x.mesh
    return None


def _unzip(results, mesh: Mesh):
    """A [iz][iy] grid of per-block tuples (None for another rank's
    block) -> a tuple of volumes (None where the blocks' entry is
    None)."""
    r0 = next(r for row in results for r in row if r is not None)
    return tuple(
        None if r0[j] is None else
        from_blocks([[None if r is None else r[j] for r in row]
                     for row in results], mesh)
        for j in range(len(r0)))


def _blur3_sharded(vol: ShardedVolume, ks) -> ShardedVolume:
    """``blur3`` of a sharded volume: each block haloed by the taps'
    halfwidths along z and y (zeros beyond the volume, as the
    single-device blur pads), blurred, and its interior kept."""
    kx, ky, kz = ks
    hz, hy = kz.shape[0] // 2, ky.shape[0] // 2
    bz, by = vol.block_shape

    def cell(iz, iy, b):
        out = blur3(b, [k.to(b.device) for k in ks])
        return out[hz:hz + bz, hy:hy + by].contiguous()
    return halo_pad_2d(vol, hz, hy).with_blocks(cell)


def separable_conv3d_sharded(
    x: ShardedVolume,
    kernels_xyz: Sequence,        # (kx, ky, kz) 1-D kernels
    mask: Optional[ShardedVolume] = None,
    normalize: bool = True,
) -> ShardedVolume:
    """``ops.conv.separable_conv3d`` on a sharded volume (same mask and
    normalisation semantics)."""
    ks = [torch.as_tensor(k, dtype=torch.float32) for k in kernels_xyz]
    if mask is not None:
        xm = bmap(torch.mul, x, mask)
        if not normalize:
            return _blur3_sharded(xm, ks)
        out, den = _blur3_sharded(xm, ks), _blur3_sharded(mask, ks)

        def divide(o, d):
            ok = d > 0
            return torch.where(ok, o / torch.where(ok, d, 1.0), o)
        return bmap(divide, out, den)
    out = _blur3_sharded(x, ks)
    if not normalize:
        return out
    # the edge normalisation: the global per-axis denominators, sliced
    kx, ky, kz = ks
    bz, by = x.block_shape
    nz, ny, nx = x.shape

    def cell(iz, iy, b):
        dev = b.device
        dz = _ones_denom_1d(kz.to(dev), nz)[iz * bz:(iz + 1) * bz]
        dy = _ones_denom_1d(ky.to(dev), ny)[iy * by:(iy + 1) * by]
        dx = _ones_denom_1d(kx.to(dev), nx)
        return b / (dz[:, None, None] * dy[None, :, None] * dx[None, None, :])
    return out.with_blocks(cell)


def _clamp_faces_sharded(vol: ShardedVolume) -> None:
    """``ops.eigen_cuda.clamp_faces`` on the y and z faces of a sharded
    (C, Z, Y, X) volume whose x faces are clamped, in place: y, then z
    across blocks (a face row comes from the next block when a block is
    one row thick, through ``with_ghosts`` when another rank holds
    it)."""
    nz_m, ny_m = vol.mesh.shape
    bz, by = vol.block_shape
    for axis in (1, 0):
        t = vol.lead + axis
        n, bs = vol.shape[t], vol.block_shape[axis]
        src_vol = vol if bs > 1 else with_ghosts(
            vol, *((0, 1) if axis == 1 else (1, 0)))
        for dst, src in ((0, 1), (n - 1, n - 2)):
            for i_other in range(nz_m if axis == 1 else ny_m):
                def cell(g):
                    return (i_other, g // bs) if axis == 1 else (g // bs,
                                                                 i_other)
                b = vol.blocks[cell(dst)[0]][cell(dst)[1]]
                if b is None:
                    continue
                r = src % bs
                box = ((0, bz, r, r + 1) if axis == 1 else (r, r + 1, 0, by))
                row = _rows(src_vol, *cell(src), *box).to(b.device)
                b.select(t, dst % bs).copy_(row.select(t, 0))


def hessian_principal_sharded(
    blur: ShardedVolume,          # (Z, Y, X) blurred volume
    sigma: float,
    decreasing: bool = True,
    formula: str = "planar",
    want_v: bool = True,
):
    """Per-shard fused FD Hessian + principal eigensolve + score:
    ``hessian_principal_block`` reads each block in place beside its
    four 1-deep halo slabs (``parallel.halo.face_halos``: no copy of a
    block), then the global y and z faces are clamped on the assembled
    result (the kernel clamps x).  Returns (score, v) as ShardedVolumes
    with the conventions of ``ops.eigen_cuda.hessian_principal``."""
    ghosted = with_ghosts(blur, 1, 1)

    def cell(iz, iy, b):
        return hessian_principal_block(b, *face_halos(ghosted, iz, iy), sigma,
                                       decreasing, formula, want_v)
    out = blur.with_blocks(cell)
    _clamp_faces_sharded(out)
    n_s = _n_score_channels(formula)
    score = out.with_blocks(lambda iz, iy, b: b[0] if n_s == 1 else b[:n_s])
    v = (out.with_blocks(lambda iz, iy, b: b[n_s:n_s + 3]) if want_v
         else None)
    return score, v


def tv_accumulate_sharded(
    saliency: ShardedVolume,      # (Z, Y, X)
    nvec: ShardedVolume,          # channel-major (3, Z, Y, X)
    mask_src: Optional[ShardedVolume],
    sigma: float,
    exponent: int,
    detect_curves: bool,
    truncate_ratio: float,
    want_denominator: bool,
    sparse: bool = False,
):
    """Raw (unnormalised) channel-major (6, Z, Y, X) votes of a sharded
    volume, and the masked denominator when ``want_denominator``:
    saliency, direction and mask haloed by the vote radius, x padded by
    it, ``tv_votes_prepadded`` on each block.  Returns (vote, den|None)
    as ShardedVolumes."""
    _, _, hw = tv_tables(sigma, truncate_ratio)
    bz, by = saliency.block_shape
    out_shape = (bz, by, saliency.shape[2])

    def haloed(vol):
        return None if vol is None else halo_pad_2d(vol, hw, hw).blocks

    sal_h, nv_h, m_h = haloed(saliency), haloed(nvec), haloed(mask_src)

    def xpad(t):
        return None if t is None else torch.nn.functional.pad(t, (hw, hw))

    results = [[None if sal_h[iz][iy] is None else tv_votes_prepadded(
        xpad(sal_h[iz][iy]), xpad(nv_h[iz][iy]), sigma, out_shape,
        exponent=exponent,
        mask_pad=None if m_h is None else xpad(m_h[iz][iy]),
        detect_curves=detect_curves, truncate_ratio=truncate_ratio,
        want_denominator=want_denominator, sparse=sparse,
        channel_major=True, nvec_channel_major=True)
        for iy in range(len(sal_h[0]))] for iz in range(len(sal_h))]
    return _unzip(results, saliency.mesh)


def sym3_score_sharded(
    t6: ShardedVolume,            # (6, Z, Y, X) channel-major
    decreasing: bool = True,
    formula: str = "stick",
    want_v: bool = False,
):
    """``ops.eigen_cuda.sym3_score`` on each block (voxelwise: no halo).
    Returns (score, v|None) as ShardedVolumes."""
    if t6.shape[0] != 6:
        raise ValueError("t6 must be channel-major (6, Z, Y, X)")
    results = [[None if b is None else sym3_score(b, decreasing, formula,
                                                   want_v) for b in row]
               for row in t6.blocks]
    return _unzip(results, t6.mesh)


def gradient_sharded(smoothed: ShardedVolume) -> ShardedVolume:
    """``features.hessian.gradient_fd`` of a sharded volume (the same
    floats), channel-major (3, Z, Y, X): each block's stencils read its
    neighbours through a 2-deep halo, the volume's faces taking the
    stencil of the nearest interior voxel."""
    bz, by = smoothed.block_shape
    ghosted = with_ghosts(smoothed, 2, 2)

    def cell(iz, iy, b):
        return fd_slab(haloed_block(ghosted, iz, iy, 2), iz * bz,
                       (iz + 1) * bz, iy * by, (iy + 1) * by,
                       (iz * bz - 2, iy * by - 2), smoothed.shape,
                       gradient_fd_padded).movedim(-1, 0)
    return smoothed.with_blocks(cell)


def make_membrane_step(
    mesh: Mesh,
    sigma: float = 2.0,
    tv_sigma: float = 2.0,
    tv_exponent: int = 4,
    saliency_threshold: float = 0.0,
    truncate_ratio: float = 2.5,
    tv_truncate_ratio: float = float(np.sqrt(2.0)),
    tv_sparse: bool = False,
):
    """The flagship membrane step over ``mesh`` (the JAX package's
    ``make_membrane_step``): Gaussian blur (halfwidth
    ``max(1, floor(sigma * truncate_ratio))``, edge-normalised), the
    Hessian x sigma^2 and its planar score and principal vector, the
    scores below ``saliency_threshold`` zeroed, stick voting and the
    vote's stick score, each stage per block with its halos.

    Returns (step, shard_input): ``step(x)`` takes a ShardedVolume
    (``shard_input(array)`` makes one) and returns (stick (Z, Y, X),
    vote) as ShardedVolumes.  Unlike the JAX step's channel-last
    (Z, Y, X, 6), the vote is channel-major (6, Z, Y, X), the layout
    the voting kernel writes.  ``tv_sparse`` runs the sparse voting
    kernel (the same bits).  The JAX step's ``tv_use_pallas`` has no
    counterpart: the per-shard kernels always run."""
    hw = max(1, int(np.floor(sigma * truncate_ratio)))
    k1 = K.gauss_kernel_1d(sigma, hw)

    def step(x: ShardedVolume):
        blur = separable_conv3d_sharded(x, (k1, k1, k1))
        score, direction = hessian_principal_sharded(
            blur, sigma, decreasing=True, formula="planar", want_v=True)
        del blur
        score = bmap(lambda sc: torch.where(sc < saliency_threshold, 0.0, sc),
                     score)
        vote, _ = tv_accumulate_sharded(
            score, direction, None, tv_sigma, tv_exponent, False,
            tv_truncate_ratio, False, sparse=tv_sparse)
        stick, _ = sym3_score_sharded(vote, decreasing=True, formula="stick")
        return stick, vote

    return step, lambda a: shard(a, mesh)
