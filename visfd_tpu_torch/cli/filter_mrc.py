"""filter_mrc for the PyTorch port: the flagship membrane run,
``-membrane|-curve|-edge … -tv … -connect …``, the stand-alone
``-connect``, the segmentation handlers ``-find-minima|-find-maxima``
and ``-watershed`` (host flood, or ``-watershed-device``), and the
intensity map that follows any handler.

Port of ``visfd_tpu/cli/filter_mrc.py``: read (or ``-image-size``) ->
mask -> voxel width -> (auto-)binning -> ``-mask-rect|-mask-sphere``
regions -> unit rescale -> one handler -> invert -> ``-thresh*``,
``-clip``, ``-thresh-gauss``, ``-rescale``, ``-fill`` -> masked
brightness -> rescale -> unbin -> write.  With no filter flag the input
goes to the intensity map as it is.

* ``handle_tv`` runs the four kernels: Gaussian blur
  (``ops/blur_cuda``), Hessian + principal eigensolve + score
  (``ops/eigen_cuda.hessian_principal``), stick voting (``ops/tv_cuda``,
  sparse under ``-tv-best`` <= 0.5) and the vote tensor's eigen score,
  with its principal eigenvector under ``-connect``
  (``ops/eigen_cuda.sym3_score``).  ``-edge`` takes the JAX CLI's
  non-fused branch (gradient, voting, the vote scored by
  ``linalg/sym3``), and so does a loaded vote (``-load-progress``, or
  ``-load-progress-sharded``).  ``-save-progress-sharded`` /
  ``-load-progress-sharded`` keep the vote, the saliency and the
  direction in a checkpoint directory (``io/checkpoint``) of which each
  rank writes and reads only its own blocks; a restore takes any mesh.
  ``-connect`` runs ``segment/connect.label_connected``: gates, seeds
  and candidate compaction on the card, the native flood on the host;
  ``-normals-file`` walks the chosen cluster on the host and writes a
  PLY.
* ``handle_extrema`` finds the plateau extrema on the card
  (``segment/extrema``); ``handle_watershed`` floods on the host
  (``segment/watershed``, seeds from the card) or, with
  ``-watershed-device``, propagates labels on the card
  (``segment/propagate``).
* The convolution filters (``-gauss``, ``-ggauss``, ``-dog``, ``-dogg``,
  ``-log``, ``-fluct``, ``-median``, ``-erode``/``-dilate``/``-open``/
  ``-close``/``-top-hat-*``) run ``ops/filters`` and ``ops/morphology``
  on the card: the separable blurs through ``blur3``, the dense ones
  through ``csrc/conv3d.cu``.
* ``-blob`` runs the DoG ladder, the 80-neighbour extremum test and the
  candidate compaction on the card (``features/blob``), the NMS in the
  native library and draws the blobs it kept (``ops/draw.draw_spheres``,
  on the card); ``-discard-blobs`` (with ``-auto-thresh score
  -supervised``), ``-supervised-multi`` and ``-draw-spheres`` work on
  blob files.
* The experimental handlers (``features/experimental``):
  ``-template-gauss`` (the background blur and the amplitude
  correlation on the card) and ``-doggxy`` (a z pass through ``blur3``,
  then the 2-D pass through ``csrc/conv3d.cu``) run like the filters;
  ``-distance-points`` computes its map on the card, ``-distance-to-voxels``
  its minima; ``-random-spheres`` and ``-blob-radial-intensity`` run on
  the host, as in the JAX package.

With ``-mesh N|auto|all`` the volume is split into (z, y) blocks over a
grid of devices (``parallel/mesh``, by default the visible cards):
``handle_tv`` runs the sharded stages (``parallel/sharded``: halo
exchange, then the per-shard kernels on every block), the ``-tv-best``
threshold as an exact radix selection over the blocks
(``parallel/reduce``), and ``-connect`` its gates, seeds and compaction
per block; ``-watershed-device`` runs the blockwise loops over the mesh
(``parallel/sharded_features``), and the filters and ``-blob`` walk the
blocks with halos as deep as their footprints.  Every output equals the
single-device run's.  A volume the mesh does not divide runs whole on
one device.

Several processes run one ``-mesh`` command as a cluster when
``VISFD_COORDINATOR``, ``VISFD_NUM_PROCESSES`` and ``VISFD_PROCESS_ID``
are set (``parallel/distributed``, joined at the start of ``run``): the
grid is drawn from every rank's devices, each rank runs the stages on
its own blocks, halos and reductions cross ranks, and the output is the
one-process output bit for bit.  Every rank reads the whole input and
gathers whole outputs (``to_host_np``); only rank 0 writes files
(``is_writer``), the text lists and the PLY included.  A volume the mesh
does not divide runs whole on every rank, and rank 0 writes.  Every
handler runs in a cluster: the sharded ones (the flagship, ``-connect``,
the filters, ``-watershed-device``, ``-blob``) over the global grid, and
those the JAX CLI runs whole on every process (``-find-*``, the host
``-watershed``, the blob tools, the distance and host handlers) whole on
every rank, with the same seeds, so that every rank holds the same
result.

The port takes every flag the settings parser takes, which raises
``InputError`` for the flags it does not know and for the renamed ones
(``-surface``, ``-planar``, ``-planar-tv``, ``-bs``,
``--membrane-normals-file``), with the JAX CLI's message.  A
``-membrane|-curve|-edge`` volume with a side below 3 voxels is refused,
as the JAX CLI's route for it (finite differences clamped to the nearest
interior voxel) raises.

Usage: python -m visfd_tpu_torch.cli.filter_mrc -in in.rec -out out.rec
       -w 1 -membrane minima 3 -tv 1.5 [-connect 0.5 -connect-angle 30]
       [-mesh 4]
       python -m visfd_tpu_torch.cli.filter_mrc -in in.rec -out ws.rec
       -watershed minima [-watershed-device] [-thresh2 0 10]
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from visfd_tpu_torch.cli import settings as S
from visfd_tpu_torch.cli.settings import InputError, Settings
from visfd_tpu_torch.features import blob as B
from visfd_tpu_torch.features import experimental as E
from visfd_tpu_torch.features import hessian as FH
from visfd_tpu_torch.features import supervised as SUP
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.io.checkpoint import load_sharded, save_sharded
from visfd_tpu_torch.io.coords import (
    fmt_g, read_blob_coords_file, read_coordinates, write_blob_coords_file)
from visfd_tpu_torch.io.pointcloud import write_oriented_pointcloud_ply
from visfd_tpu_torch.linalg import sym3
from visfd_tpu_torch.ops import draw as D
from visfd_tpu_torch.ops import filters as F
from visfd_tpu_torch.ops import kernels as K
from visfd_tpu_torch.ops import morphology as M
from visfd_tpu_torch.ops import resample as R
from visfd_tpu_torch.ops import threshold as T
from visfd_tpu_torch.ops.eigen_cuda import hessian_principal, sym3_score
from visfd_tpu_torch.ops.tv_cuda import tv_votes
from visfd_tpu_torch.parallel.distributed import (
    allgather_concat, init_distributed)
from visfd_tpu_torch.parallel.gather import is_writer, to_host_np
from visfd_tpu_torch.parallel.mesh import (
    Mesh, ShardedVolume, as_blocks, bmap, divides, make_mesh, shard, unwrap)
from visfd_tpu_torch.parallel.reduce import fraction_threshold
from visfd_tpu_torch.parallel.sharded import (
    gradient_sharded, grid_mesh_of, hessian_principal_sharded,
    sym3_score_sharded, tv_accumulate_sharded)
from visfd_tpu_torch.segment.connect import label_connected
from visfd_tpu_torch.segment.extrema import find_extrema, flat_to_xyz
from visfd_tpu_torch.segment.propagate import propagate_watershed
from visfd_tpu_torch.segment.watershed import watershed
from visfd_tpu_torch.utils.progress import Report, stage
from visfd_tpu_torch.utils.transfer import to_device, to_host

def _join_cluster(mesh_devices) -> None:
    """``init_distributed`` for a -mesh run: gloo when the rank's
    devices are all on the host, else the default (NCCL where a card is
    visible), under NCCL on the rank's card."""
    devs = None if mesh_devices is None else [torch.device(d)
                                              for d in mesh_devices]
    cards = [d for d in devs or () if d.type == "cuda"]
    init_distributed(backend="gloo" if devs and not cards else None,
                     device=cards[0] if cards else None)


def _truncate_ratio(s: Settings) -> float:
    if s.filter_truncate_ratio > 0:
        return s.filter_truncate_ratio
    if not s.filter_truncate_threshold > 0:
        raise InputError("Error: the truncation threshold must be > 0")
    return float(np.sqrt(-2.0 * np.log(s.filter_truncate_threshold)))


def _cli_mesh(s: Settings, devices=None) -> Optional[Mesh]:
    """The (z, y) device mesh requested with ``-mesh``, or None; drawn
    from ``devices`` (default: the visible CUDA cards)."""
    if not s.mesh_devices:
        return None
    return make_mesh(None if s.mesh_devices < 0 else s.mesh_devices,
                     devices=devices)


def _maybe_shard(arr, mesh: Optional[Mesh], device, rep=None):
    """``arr`` split into the mesh's (z, y) blocks, or whole on
    ``device`` without a mesh; the copies counted in ``rep``."""
    if arr is None:
        return None
    if mesh is None:
        return to_device(arr, device, rep, torch.float32)
    return shard(arr, mesh, report=rep)


def determine_voxel_width(s: Settings, img: mrc.MrcImage) -> np.ndarray:
    """``DetermineVoxelWidth`` (``handlers.cpp:2429-2531``)."""
    if s.voxel_width > 0:
        w = np.full(3, s.voxel_width, np.float64)
        if s.resize_with_binning > 0:
            w *= s.resize_with_binning
        return w
    nx, ny, nz = img.header.nvoxels
    if nx == 0 or ny == 0 or nz == 0:
        return np.full(3, -1.0)
    w = np.asarray(img.header.voxel_width_xyz, np.float64)
    if s.voxel_width_divide_by_10:
        w = w * 0.1
    print(f"voxel width in physical units = ({w[0]:.8g}, {w[1]:.8g}, "
          f"{w[2]:.8g})", file=sys.stderr)
    if w.max() != w.min():
        ave = w.mean()
        if (w.max() - w.min()) > 0.000005 * ave:
            raise InputError(
                "ERROR: The voxel width in the X,Y,Z directions varies by "
                "more than 0.0005%.\nUse the -w argument.")
        w = np.full(3, ave)
    if (abs((w[0] - w[1]) / (0.5 * (w[0] + w[1]))) > 1e-4
            or abs((w[0] - w[2]) / (0.5 * (w[0] + w[2]))) > 1e-4):
        raise InputError("Error: unequal voxel widths; use -w")
    return w


def handle_binning(s: Settings, img, mask_img, w, device, rep: Report):
    """``HandleBinning`` (``handlers.cpp:2361-2425``): the stage "bin
    the tomogram" (the upload, the bin and the download of the
    tomogram, and of the mask)."""
    nz, ny, nx = img.data.shape
    b = s.resize_with_binning
    new_zyx = (nz // b, ny // b, nx // b)
    vw = s.voxel_width if s.voxel_width > 0 else img.header.cellA[0] / nx
    vw = vw * b

    def binned(a):
        return to_host(R.bin_array3d(to_device(a, device, rep, torch.float32),
                                     new_zyx), rep)

    with stage("bin the tomogram", rep):
        img.data = binned(img.data)
        if mask_img is not None:
            mask_img = binned(mask_img)
    img.header.nvoxels = (new_zyx[2], new_zyx[1], new_zyx[0])
    img.header.cellA = tuple(vw * n for n in img.header.nvoxels)
    w[:] = vw
    return img, mask_img


def handle_tv(s: Settings, img: mrc.MrcImage, x_np, mask_np, w, device,
              rep: Report, mesh: Optional[Mesh] = None) -> np.ndarray:
    """``HandleTV`` (``handlers.cpp:1501-2357``): the JAX CLI's
    branches, on ``device`` or, with a ``mesh``, sharded over its (z, y)
    blocks.  A volume the mesh does not divide runs on ``device``, as
    the JAX CLI leaves it to XLA."""
    curve = s.filter_type == S.CURVE
    edge = s.filter_type == S.SURFACE_EDGE
    decreasing = not s.ridges_are_maxima
    order = (sym3.EigenOrder.DECREASING if decreasing
             else sym3.EigenOrder.INCREASING)
    sigma = s.width_a[0]
    tr = _truncate_ratio(s)
    mesh = _mesh_for(x_np, mesh)
    with stage("copy the volume to the device", rep):
        x = _maybe_shard(x_np, mesh, device, rep)
        mask = _maybe_shard(mask_np, mesh, device, rep)
    keep = None if mask is None else bmap(lambda m: m != 0, mask)
    sharded = grid_mesh_of(x) is not None
    on_card = (x.local_block.device if sharded
               else device).type == "cuda"
    route = ("cuda" if on_card else "plain") + ("-sharded" if sharded
                                                else "")
    hessian = hessian_principal_sharded if sharded else hessian_principal
    vote_score = sym3_score_sharded if sharded else sym3_score

    background = None
    if s.width_b[0] > 0:
        hw = max(1, int(np.floor(s.width_b[0] * tr)))
        background = F.apply_gauss(
            x, s.width_b[0], mask=mask, truncate_halfwidth=(hw,) * 3,
            normalize=s.normalize_near_boundaries)

    with stage("gaussian blur + hessian + eigendecomposition", rep):
        if edge:
            # the JAX CLI's non-fused branch: the score is |gradient| and
            # the voting direction the gradient itself, channel-major,
            # block by block (one device being a 1 x 1 grid)
            hw = max(1, int(np.floor(sigma * tr)))
            blur = F.apply_gauss(x, sigma, mask=mask,
                                 truncate_halfwidth=(hw,) * 3)
            direction = bmap(lambda g: g * sigma, unwrap(
                gradient_sharded(as_blocks(blur)), blur))
            if keep is not None:
                direction = bmap(lambda d, k: d * k[None], direction, keep)
            score = bmap(lambda d: torch.sqrt(
                (d.movedim(0, -1) * d.movedim(0, -1)).sum(-1)), direction)
            rep.record_path("hessian_eigen", "gradient" + (
                "-sharded" if sharded else ""))
        else:
            hwb = max(1, int(np.floor(sigma * tr)))
            blur = F.apply_gauss(x, sigma, mask=mask,
                                 truncate_halfwidth=(hwb,) * 3)
            score, direction = hessian(
                blur, sigma, decreasing=decreasing,
                formula="linear" if curve else "planar", want_v=True)
            rep.record_path("hessian_eigen", route)
    if background is not None:
        score = bmap(lambda sc, v, bg: sc * (v - bg), score, x, background)
    if keep is not None:
        score = bmap(lambda sc, k: torch.where(k, sc, 0.0), score, keep)
        if not edge:
            direction = bmap(torch.mul, direction, keep)

    # saliency thresholding (top fraction) -- handlers.cpp:1751-1797
    thr = s.hessian_score_threshold
    if s.hessian_score_threshold_is_a_fraction:
        print(" -- sorting all voxels by ridge saliency --\n",
              file=sys.stderr)
        with stage("-tv-best threshold", rep):
            thr = fraction_threshold(score, thr, mask=mask)
    score = bmap(lambda sc: torch.where(sc < thr, 0.0, sc), score)

    vote = None     # channel-major (6, Z, Y, X) vote tensor
    vec = None      # its principal eigenvector (3, Z, Y, X), for -connect
    if s.tv_sigma > 0:
        # -tv-best kept only the top fraction of saliencies: the sparse
        # kernel skips the all-zero source planes (feature.hpp:1704-1709)
        tv_sparse = bool(s.hessian_score_threshold_is_a_fraction
                         and float(s.hessian_score_threshold) <= 0.5)
        if s.load_progress_sharded or s.load_intermediate_fname_base:
            with stage("-load-progress-sharded" if s.load_progress_sharded
                       else "-load-progress", rep):
                vote = _load_progress(s, mesh, device, x_np.shape, rep)
            if keep is not None:
                vote = bmap(lambda v, k: v * k[None], vote, keep)
        else:
            with stage("dense stick tensor voting", rep):
                if sharded:
                    vote, _ = tv_accumulate_sharded(
                        score, direction, mask, s.tv_sigma, s.tv_exponent,
                        curve, s.tv_truncate_ratio, False, sparse=tv_sparse)
                else:
                    vote, _ = tv_votes(
                        score, direction, s.tv_sigma,
                        exponent=s.tv_exponent, mask_src=mask,
                        detect_curves=curve,
                        truncate_ratio=s.tv_truncate_ratio,
                        sparse=tv_sparse, channel_major=True,
                        nvec_channel_major=True)
                if keep is not None:
                    vote = bmap(lambda v, k: torch.where(k[None], v, 0.0),
                                vote, keep)
                rep.record_path("tv", route + ("-sparse" if tv_sparse
                                               and on_card else ""))
        with stage("eigen score of the vote tensor", rep):
            if (edge or s.load_intermediate_fname_base
                    or s.load_progress_sharded):
                # the JAX CLI scores a channel-last vote with the full
                # solver (its non-fused branch); the vector comes from
                # principal_sym3, below
                new_score = bmap(lambda v: _vote_score_plain(v, order, curve),
                                 vote)
                rep.record_path("vote_eigen", "plain")
            else:
                new_score, vec = vote_score(
                    vote, decreasing=decreasing,
                    formula="linear" if curve else "stick",
                    want_v=bool(s.cluster_connected_voxels))
                rep.record_path("vote_eigen", route)
        if background is not None:
            new_score = bmap(lambda sc, v, bg: sc * (v - bg), new_score, x,
                             background)
        if keep is not None:
            new_score = bmap(lambda n, k, sc: torch.where(k, n, sc),
                             new_score, keep, score)
        score = new_score

    if s.save_intermediate_fname_base and vote is not None:
        with stage("-save-progress", rep):
            # a collective
            vote_np = to_host_np(vote, report=rep) if sharded else None
            for d in range(6):
                fname = f"{s.save_intermediate_fname_base}_tensor_{d}.rec"
                if is_writer():
                    print(f'writing "{fname}"', file=sys.stderr)
                    mrc.write_mrc(fname, vote_np[d] if sharded
                                  else to_host_np(vote[d], report=rep),
                                  header=img.header)

    if s.save_progress_sharded and vote is not None:
        # each rank writes its own blocks: no gather
        if is_writer():
            print(f'writing sharded checkpoint "{s.save_progress_sharded}"',
                  file=sys.stderr)
        with stage("-save-progress-sharded", rep):
            rep.record_count("-save-progress-sharded bytes written",
                             save_sharded(s.save_progress_sharded, {
                                 "vote": vote, "saliency": score,
                                 "direction": direction}))

    rep.line(rep.format_paths())
    direction_np = None
    labels_img = None
    if s.cluster_connected_voxels and vote is not None:
        if vec is None:
            vec = bmap(lambda vote_b: _by_slabs(
                lambda v: sym3.principal_sym3(sym3.flat_to_full(
                    v.movedim(0, -1)), order=order)[1].movedim(-1, 0),
                vote_b), vote)
        res = label_connected(
            score, mask=mask,
            threshold_saliency=s.connect_threshold_saliency,
            vector=vec,
            threshold_vector_saliency=s.connect_threshold_vector_saliency,
            threshold_vector_neighbor=s.connect_threshold_vector_neighbor,
            consider_dot_product_sign=False,
            tensor=vote,
            threshold_tensor_saliency=s.connect_threshold_tensor_saliency,
            threshold_tensor_neighbor=s.connect_threshold_tensor_neighbor,
            tensor_is_positive_definite_near_target=True,
            connectivity=1, label_undefined=-1,
            standardize_vector_sign=True,
            must_link=s.must_link_constraints or None,
            must_link_directions=s.must_link_directions or None,
            start_from_saliency_maxima=True,
            # the dense standardized field is read only by the PLY writer
            want_dense_vectors=bool(s.out_normals_fname),
            report=rep)
        direction_np = res.vector_standardized
        out = labels_img = _cluster_image(res, s)
    else:
        with stage("copy the result to the host", rep):
            out = to_host_np(score, report=rep)

    if s.out_normals_fname:
        # the gathers are collectives; the walker and the file rank 0's
        if direction_np is None:
            direction_np = np.moveaxis(to_host_np(direction, report=rep),
                                       0, -1)
        score_np = to_host_np(score, report=rep)
        if is_writer():
            with stage("-normals-file", rep):
                write_normals(s, score_np, direction_np, labels_img,
                              mask_np, w)
    return out


def _load_progress(s: Settings, mesh, device, zyx, rep: Report):
    """The saved vote tensor, channel-major, on ``device`` (or sharded
    over ``mesh``): from the checkpoint of ``-load-progress-sharded``
    (each rank reads the blocks that meet its own), else from the six
    ``{base}_tensor_{d}.rec`` channels of ``-load-progress``."""
    if s.load_progress_sharded:
        print(f'loading sharded checkpoint "{s.load_progress_sharded}"',
              file=sys.stderr)
        vote = load_sharded(s.load_progress_sharded, like=mesh,
                            device=device, names=("vote",), zyx=zyx)["vote"]
        rep.record_count("-load-progress-sharded bytes read", sum(
            b.numel() * b.element_size() for _, _, b in as_blocks(vote)
            .cells()))
        return vote
    chans = []
    for d in range(6):
        fname = f"{s.load_intermediate_fname_base}_tensor_{d}.rec"
        print(f'loading "{fname}"', file=sys.stderr)
        chans.append(mrc.read_mrc(fname).data)
    vote = np.stack(chans).astype(np.float32)
    if mesh is not None:
        return shard(vote, mesh, lead=1, report=rep)
    return to_device(vote, device, rep)


# voxels a slab of the plain full solver takes at once: its temporaries
# hold ~0.4 KB a voxel, 200 GiB for a whole 537M-voxel vote
_SLAB_VOXELS = 1 << 23


def _by_slabs(fn, vote_cm):
    """``fn`` of a channel-major vote tensor, applied to slabs of its z
    planes and joined along z (every voxel's result is its own)."""
    step = max(1, _SLAB_VOXELS // (vote_cm.shape[-2] * vote_cm.shape[-1]))
    return torch.cat([fn(vote_cm[:, z:z + step])
                      for z in range(0, vote_cm.shape[1], step)], dim=-3)


def _vote_score_plain(vote_cm, order, curve):
    """The stick|linear score of a channel-major vote tensor through the
    full solver (``diagonalize_flat_sym3``), a slab at a time."""
    score = FH.score_tensor_linear if curve else FH.score_tensor_planar
    return _by_slabs(lambda v: score(sym3.diagonalize_flat_sym3(
        v.movedim(0, -1), order=order)[..., :3]), vote_cm)


def _cluster_image(res, s: Settings) -> np.ndarray:
    """The float32 label image of a ``ConnectResult``: clusters 1..N,
    every other voxel at ``-undefined-out`` (default: N + 1)."""
    labels = res.labels
    out = labels.astype(np.float32)
    undef = (labels > res.num_clusters) | (labels == -1)
    if s.undefined_voxels_are_max:
        defined = out[~undef]
        max_label = defined.max() if defined.size else -1.0
        out[undef] = max_label + 1
    else:
        out[undef] = s.undefined_voxel_brightness
    return out


def write_normals(s: Settings, score_np, direction_np, labels_img, mask_np,
                  w) -> None:
    """``-normals-file``: an oriented point per voxel of the mask, or,
    after ``-connect``, a refined surface point per voxel of cluster
    ``-select-cluster`` (``handlers.cpp:2088-2307``), written as PLY in
    physical units.  Host numpy, one voxel at a time."""
    sel = np.ones(score_np.shape, bool)
    if mask_np is not None:
        sel &= mask_np != 0
    crds, norms = [], []
    if labels_img is None:
        for z, y, xq in zip(*np.nonzero(sel)):
            crds.append((xq * w[0], y * w[1], z * w[2]))
            norms.append(tuple(direction_np[z, y, xq]))
    else:
        sel &= labels_img == s.select_cluster
        for z, y, xq in zip(*np.nonzero(sel)):
            xyz, normal = _surface_point(s, score_np, direction_np,
                                         labels_img, mask_np, int(xq),
                                         int(y), int(z))
            if xyz is None:
                continue
            crds.append(tuple(c * wi for c, wi in zip(xyz, w)))
            norms.append(tuple(normal))
    write_oriented_pointcloud_ply(s.out_normals_fname,
                                  np.asarray(crds).reshape(-1, 3),
                                  np.asarray(norms).reshape(-1, 3))


def _surface_point(s, saliency, direction, labels_img, mask_np, ix, iy, iz):
    """Per-voxel surface-point refinement for -normals-file
    (``handlers.cpp:2088-2307``): curve-integration averaging along the
    normal direction, then optional sub-voxel ridge projection."""
    nz, ny, nx = saliency.shape
    norm_v = np.linalg.norm(direction[iz, iy, ix])
    if norm_v == 0:
        return None, None
    normal = direction[iz, iy, ix] / norm_v * saliency[iz, iy, ix]
    xyz = np.array([ix, iy, iz], float)

    def inside(ixyz):
        return (0 <= ixyz[0] < nx and 0 <= ixyz[1] < ny
                and 0 <= ixyz[2] < nz
                and (mask_np is None
                     or mask_np[ixyz[2], ixyz[1], ixyz[0]] != 0)
                and labels_img[ixyz[2], ixyz[1], ixyz[0]] == my_cluster)

    if s.surface_normal_curve_ds > 0:
        ds = s.surface_normal_curve_ds
        my_cluster = labels_img[iz, iy, ix]

        def walk(sign):
            out_s, out_xyz, out_w = [], [], []
            r = np.array([ix, iy, iz], float)
            ixyz = np.array([ix, iy, iz], int)
            sacc = 0.0
            while True:
                if sign > 0:
                    if not inside(ixyz):
                        break
                    out_s.append(sacc)
                    out_xyz.append(r.copy())
                    out_w.append(saliency[ixyz[2], ixyz[1], ixyz[0]])
                d = direction[ixyz[2], ixyz[1], ixyz[0]]
                nrm = np.linalg.norm(d)
                if nrm == 0:
                    break
                sacc += sign * ds
                r = r + sign * ds * d / nrm
                ixyz = np.round(r).astype(int)
                if sign < 0:
                    if not inside(ixyz):
                        break
                    out_s.append(sacc)
                    out_xyz.append(r.copy())
                    out_w.append(saliency[ixyz[2], ixyz[1], ixyz[0]])
            return out_s, out_xyz, out_w

        vs, vxyz, vw_ = walk(+1)
        bs, bxyz, bw = walk(-1)
        vs = list(reversed(bs)) + vs
        vxyz = list(reversed(bxyz)) + vxyz
        vw_ = list(reversed(bw)) + vw_
        if not vs or sum(vw_) == 0:
            return None, None
        ave_s = float(np.dot(vw_, vs) / np.sum(vw_))
        i = 0
        while i + 1 < len(vs):
            i += 1
            if vs[i - 1] <= ave_s <= vs[i]:
                break
        ixyz2 = np.round(vxyz[i]).astype(int)
        ixyz2 = np.clip(ixyz2, 0, [nx - 1, ny - 1, nz - 1])
        d = direction[ixyz2[2], ixyz2[1], ixyz2[0]]
        nrm = np.linalg.norm(d)
        if nrm > 0:
            normal = d / nrm
        if i + 1 < len(vs) and vs[i] != vs[i - 1]:
            frac = (ave_s - vs[i - 1]) / (vs[i] - vs[i - 1])
            xyz = np.asarray(vxyz[i - 1]) + (
                np.asarray(vxyz[i]) - np.asarray(vxyz[i - 1])) * frac
        else:
            xyz = np.asarray(vxyz[i])
        normal = normal * saliency[iz, iy, ix]

    if s.surface_find_ridge:
        ix0, iy0, iz0 = (int(np.round(c)) for c in xyz)
        ix0 = min(max(ix0, 0), nx - 1)
        iy0 = min(max(iy0, 0), ny - 1)
        iz0 = min(max(iz0, 0), nz - 1)
        # local FD Hessian and gradient of the saliency at this voxel
        h = _local_hessian(saliency, ix0, iy0, iz0)
        g = _local_gradient(saliency, ix0, iy0, iz0)
        vals, vects = sym3.diagonalize_sym3(
            torch.from_numpy(h[None]), order=sym3.EigenOrder.DECREASING_ABS)
        v1 = vects[0, 0].numpy()
        lam1 = float(vals[0, 0])
        gv = float(g @ v1)
        if gv < 0:
            gv = -gv
            v1 = -v1
        elif gv == 0:
            return None, None
        dist = gv / lam1 if lam1 != 0 else np.inf
        if s.max_distance_to_feature > 0 and abs(dist) > \
           s.max_distance_to_feature:
            return None, None
        xyz = np.array([ix0, iy0, iz0], float) - dist * v1
        if not (0 <= xyz[0] <= nx and 0 <= xyz[1] <= ny
                and 0 <= xyz[2] <= nz):
            return None, None
    return xyz, normal


def _clamp_idx(i, n):
    return min(max(i, 1), n - 2)


def _local_hessian(a, ix, iy, iz):
    nz, ny, nx = a.shape
    ix, iy, iz = _clamp_idx(ix, nx), _clamp_idx(iy, ny), _clamp_idx(iz, nz)
    hxx = a[iz, iy, ix + 1] + a[iz, iy, ix - 1] - 2 * a[iz, iy, ix]
    hyy = a[iz, iy + 1, ix] + a[iz, iy - 1, ix] - 2 * a[iz, iy, ix]
    hzz = a[iz + 1, iy, ix] + a[iz - 1, iy, ix] - 2 * a[iz, iy, ix]
    hxy = 0.25 * (a[iz, iy + 1, ix + 1] + a[iz, iy - 1, ix - 1]
                  - a[iz, iy - 1, ix + 1] - a[iz, iy + 1, ix - 1])
    hyz = 0.25 * (a[iz + 1, iy + 1, ix] + a[iz - 1, iy - 1, ix]
                  - a[iz - 1, iy + 1, ix] - a[iz + 1, iy - 1, ix])
    hxz = 0.25 * (a[iz + 1, iy, ix + 1] + a[iz - 1, iy, ix - 1]
                  - a[iz + 1, iy, ix - 1] - a[iz - 1, iy, ix + 1])
    return np.array([[hxx, hxy, hxz], [hxy, hyy, hyz], [hxz, hyz, hzz]],
                    np.float32)


def _local_gradient(a, ix, iy, iz):
    nz, ny, nx = a.shape
    ix, iy, iz = _clamp_idx(ix, nx), _clamp_idx(iy, ny), _clamp_idx(iz, nz)
    return np.array([
        0.5 * (a[iz, iy, ix + 1] - a[iz, iy, ix - 1]),
        0.5 * (a[iz, iy + 1, ix] - a[iz, iy - 1, ix]),
        0.5 * (a[iz + 1, iy, ix] - a[iz - 1, iy, ix])], np.float32)


def _mesh_for(x_np, mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` if it divides the volume; else None (the volume then
    runs on one device, as the JAX CLI leaves it to XLA)."""
    if mesh is not None and not divides(x_np.shape, mesh):
        print(f"-mesh: volume {tuple(x_np.shape)} not divisible by the "
              f"{mesh.shape} device grid; sharding axes (None, None)",
              file=sys.stderr)
        return None
    return mesh


def handle_label_connected(s: Settings, x_np, mask_np, device,
                           rep: Report, mesh: Optional[Mesh] = None
                           ) -> np.ndarray:
    """``HandleLabelConnected`` (``handlers.cpp:1398-1495``): the
    stand-alone ``-connect`` on the input image itself, over the mesh's
    blocks with ``-mesh``."""
    mesh = _mesh_for(x_np, mesh)
    with stage("copy the volume to the device", rep):
        x = _maybe_shard(x_np, mesh, device, rep)
        mask = _maybe_shard(mask_np, mesh, device, rep)
    res = label_connected(
        x, mask=mask, threshold_saliency=s.connect_threshold_saliency,
        connectivity=1, label_undefined=-1,
        must_link=s.must_link_constraints or None,
        must_link_directions=s.must_link_directions or None,
        start_from_saliency_maxima=s.clusters_begin_at_maxima, report=rep)
    return _cluster_image(res, s)


def handle_extrema(s: Settings, x_np, mask_np, w, device,
                   rep: Report) -> np.ndarray:
    """``HandleExtrema`` (``handlers.cpp:1086-1245``): the plateau
    extrema found on ``device``; only their lists and the label image
    come back.  A list's file is written only when it is not empty."""
    with stage("copy the volume to the device", rep):
        x = to_device(x_np, device, rep, torch.float32)
        mask = (None if mask_np is None
                else to_device(mask_np, device, rep, torch.float32))
    with stage("find extrema", rep):
        res = find_extrema(
            x, mask=mask, find_minima=s.find_minima,
            find_maxima=s.find_maxima,
            minima_threshold=s.score_upper_bound,
            maxima_threshold=s.score_lower_bound,
            connectivity=s.neighbor_connectivity,
            allow_borders=s.extrema_on_boundary, want_label_image=True)
    print(f"Found {res.num_extrema} extrema", file=sys.stderr)

    def write(fname, idxs, nvox, scores):
        ix, iy, iz = flat_to_xyz(np.asarray(idxs, np.int64), x_np.shape)
        with open(fname, "w") as fh:
            for i in range(len(idxs)):
                fh.write(f"{fmt_g(ix[i] * w[0])} {fmt_g(iy[i] * w[1])} "
                         f"{fmt_g(iz[i] * w[2])} {nvox[i]} "
                         f"{fmt_g(scores[i])}\n")

    if s.find_minima and len(res.minima_indices) and is_writer():
        write(s.find_minima_file_name, res.minima_indices,
              res.minima_nvoxels, res.minima_scores)
    if s.find_maxima and len(res.maxima_indices) and is_writer():
        write(s.find_maxima_file_name, res.maxima_indices,
              res.maxima_nvoxels, res.maxima_scores)
    out = res.label_image.astype(np.float32)
    if mask_np is not None:
        out = np.where(mask_np != 0, out, 0.0).astype(np.float32)
    return out


def handle_watershed(s: Settings, x_np, mask_np, device, rep: Report,
                     mesh: Optional[Mesh] = None):
    """``HandleWatershed`` (``handlers.cpp:1279-1391``): the host Meyer
    flood (seeds found on the card), or with ``-watershed-device`` the
    label propagation on the card (over the mesh's blocks with
    ``-mesh``).  Returns the float32 output image on the card (or its
    blocks), which ``run`` copies to the host."""
    markers = None
    if s.watershed_markers_filename:
        markers = np.round(mrc.read_mrc(
            s.watershed_markers_filename).data).astype(np.int64)
    kw = dict(mask=mask_np, markers=markers,
              start_from_minima=not s.clusters_begin_at_maxima,
              halt_threshold=s.watershed_threshold,
              connectivity=s.neighbor_connectivity,
              show_boundaries=s.watershed_show_boundaries,
              label_boundary=int(s.watershed_boundary_label),
              label_undefined=-1)
    if s.watershed_on_device:
        mesh = _mesh_for(x_np, mesh)
        with stage("copy the volume to the device", rep):
            x = _maybe_shard(x_np, mesh, device, rep)
            kw["mask"] = _maybe_shard(mask_np, mesh, device, rep)
        with stage("watershed-device", rep):
            res = propagate_watershed(x, report=rep, **kw)
        rep.record_path("watershed", "device" + ("-sharded" if mesh
                                                 else ""))
    else:
        if x_np.size >= 256 ** 3:
            print("note: the host Meyer flood is serial at this volume; "
                  "-watershed-device propagates the labels on the card "
                  "(label-level parity wherever intensities are distinct)",
                  file=sys.stderr)
        with stage("copy the volume to the device", rep):
            x = to_device(x_np, device, rep, torch.float32)
            if mask_np is not None:
                kw["mask"] = to_device(mask_np, device, rep)
        res = watershed(x, report=rep, **kw)
        rep.record_path("watershed", "native")
    print(f"Number of basins found: {res.num_basins}", file=sys.stderr)
    rep.record_count("watershed basins", res.num_basins)
    labels = res.labels
    if isinstance(labels, np.ndarray):
        labels = to_device(labels, device, rep)
    undef_value = s.undefined_voxel_brightness
    if s.undefined_voxels_are_max:
        lab = as_blocks(labels)
        top = np.array([max(int(b.max()) if b.numel() else 0
                            for _, _, b in lab.cells())])
        if lab.mesh.spans_processes:
            top = allgather_concat(top)
        undef_value = int(top.max()) + 1
    mask = kw["mask"]   # on the device (or sharded) since its upload

    def image(lab, m=None):
        out = torch.where(lab == -1, undef_value, lab.to(torch.float32))
        if m is not None:
            out = torch.where(m == 0, s.undefined_voxel_brightness, out)
        return out.to(torch.float32)
    return (bmap(image, labels) if mask is None
            else bmap(image, labels, mask))


def handle_thresholds(s: Settings, out_np, mask_np, device,
                      rep: Report) -> np.ndarray:
    """``HandleThresholds`` (``handlers.cpp:1003-1081``), on ``device``:
    the intensity map of the handler's output (the JAX CLI maps the
    image the handler left, as the reference reads ``tomo_in``); the
    ``-cl`` mean and deviation in float64 on the host, as there."""
    a, b = s.in_threshold_01_a, s.in_threshold_01_b
    if s.out_thresh2_use_clipping_sigma:
        vals = out_np if mask_np is None else out_np[mask_np != 0]
        ave = float(vals.mean(dtype=np.float64))
        std = float(vals.std(dtype=np.float64))
        a = ave + s.in_threshold_01_a * std
        b = ave + s.in_threshold_01_b * std
        print(f"ave={fmt_g(ave)}, stddev={fmt_g(std)}", file=sys.stderr)
        print(f"  Clipping intensities between [{fmt_g(a)}, {fmt_g(b)}]",
              file=sys.stderr)
    x = to_device(out_np, device, rep, torch.float32)
    if s.use_rescale_multiply:
        out = x * s.out_rescale_multiply + s.out_rescale_offset
    elif s.use_gauss_thresholds:
        out = T.select_intensity_range_gauss(
            x, s.out_thresh_gauss_x0, s.out_thresh_gauss_sigma,
            s.out_thresh_a_value, s.out_thresh_b_value)
    elif not s.use_dual_thresholds:
        if a == b:
            out = torch.where(x > a, s.out_thresh_b_value,
                              s.out_thresh_a_value)
        else:
            oa = a if s.out_thresh2_use_clipping else s.out_thresh_a_value
            ob = b if s.out_thresh2_use_clipping else s.out_thresh_b_value
            out = T.threshold2(x, a, b, oa, ob)
    else:
        out = T.threshold4(x, s.in_threshold_01_a, s.in_threshold_01_b,
                           s.in_threshold_10_a, s.in_threshold_10_b,
                           s.out_thresh_a_value, s.out_thresh_b_value)
    return to_host(out.to(torch.float32), rep)


def _mask_regions(s: Settings, mask_np, shape, w):
    """The mask with ``-mask-rect``/``-mask-sphere`` regions painted in
    (``filter_mrc.cpp:222-287``; a mask of zeros when none was read)."""
    if mask_np is None:
        mask_np = np.zeros(shape, np.float32)
    else:
        mask_np = np.array(mask_np, np.float32)
    scale = (1.0 / s.resize_with_binning if s.is_mask_crds_in_voxels
             else 1.0 / w[0])
    regions = []
    for reg in s.mask_regions:
        p = tuple(v * scale for v in reg.params)
        regions.append(D.Rect(*p, value=reg.value) if reg.kind == "rect"
                       else D.Sphere(*p, value=reg.value))
    return D.draw_regions(mask_np, regions, negative_means_subtract=True)


# ---------------------------------------------------------------------------
# the convolution filters, morphology and the blob handlers
# (the JAX CLI's, filter_mrc.py:157-245, 360-541): x and mask are tensors
# on the card, or ShardedVolumes with -mesh; each returns its result
# there, and run() brings it to the host


def handle_gauss(s: Settings, x, mask):
    sig = s.width_a
    hw = [max(1, int(np.floor(si * _truncate_ratio(s)))) for si in sig]
    return F.apply_gauss(x, tuple(sig), mask=mask, truncate_halfwidth=hw,
                         normalize=s.normalize_near_boundaries)


def handle_ggauss(s: Settings, x, mask):
    # generalized Gaussians convert the truncate threshold with their
    # own exponent: ratio = (-ln t)^(1/m), NOT the m=2 Gaussian formula
    # (filter3d_variants.hpp:87-110)
    if s.filter_truncate_ratio > 0:
        tr = s.filter_truncate_ratio
    else:
        tr = K.halfwidth_from_threshold(1.0, s.m_exp,
                                        s.filter_truncate_threshold)
    out = F.apply_gen_gauss(x, tuple(s.width_a), s.m_exp, mask=mask,
                            truncate_ratio=tr,
                            normalize=s.normalize_near_boundaries)
    if mask is not None:
        out = bmap(lambda o, m: torch.where(m != 0, o, 0.0), out, mask)
    return out


def handle_dogg(s: Settings, x, mask):
    """``HandleDogg`` (``handlers.cpp:265-293``): difference of
    generalized Gaussians honouring ``-exponents m n``; dense
    convolution, no edge normalisation."""
    return F.apply_dogg(
        x, tuple(s.width_a), tuple(s.width_b), s.m_exp, s.n_exp, mask=mask,
        truncate_ratio=s.filter_truncate_ratio,
        truncate_threshold=s.filter_truncate_threshold)


def handle_dog(s: Settings, x, mask):
    # each Gaussian with its own sigma-derived window
    # (filter3d_variants.hpp:544-590)
    tr = _truncate_ratio(s)
    hwa = [max(1, int(np.floor(si * tr))) for si in s.width_a]
    hwb = [max(1, int(np.floor(si * tr))) for si in s.width_b]
    ga = F.apply_gauss(x, tuple(s.width_a), mask=mask, truncate_halfwidth=hwa)
    gb = F.apply_gauss(x, tuple(s.width_b), mask=mask, truncate_halfwidth=hwb)
    return bmap(torch.sub, ga, gb)


def handle_log(s: Settings, x, mask):
    return F.apply_log(x, tuple(s.log_width), mask=mask,
                       delta_sigma_over_sigma=s.delta_sigma_over_sigma,
                       truncate_ratio=_truncate_ratio(s))


def handle_median(s: Settings, x, mask):
    return F.median_filter(x, s.median_radius, mask=mask)


def handle_morphology(s: Settings, x, mask):
    fn = {
        S.DILATION: M.dilate_sphere,
        S.EROSION: M.erode_sphere,
        S.OPENING: M.open_sphere,
        S.CLOSING: M.close_sphere,
        S.TOP_HAT_WHITE: M.white_top_hat_sphere,
        S.TOP_HAT_BLACK: M.black_top_hat_sphere,
    }[s.filter_type]
    return fn(x, s.morphology_r, mask=mask, radius_max=s.morphology_rmax,
              bmax=s.morphology_bmax if s.morphology_rmax > 0 else 0.0)


def handle_fluct(s: Settings, x, mask):
    # threshold -> ratio conversion uses the template exponent:
    # ratio = (-ln t)^(1/m) (filter3d_variants.hpp:652-681)
    if s.filter_truncate_ratio > 0:
        tr = s.filter_truncate_ratio
    else:
        tr = K.halfwidth_from_threshold(
            1.0, s.template_background_exponent,
            s.filter_truncate_threshold)
    return F.local_fluctuations_by_radius(
        x, tuple(s.template_background_radius), mask=mask,
        m_exp=s.template_background_exponent, truncate_ratio=tr,
        normalize=s.normalize_near_boundaries)


def handle_template_gauss(s: Settings, x, mask):
    """``HandleTemplateGauss`` (``handlers_unsupported.cpp:787-1061``):
    the least-squares template amplitude image."""
    ratio = s.filter_truncate_ratio if s.filter_truncate_ratio > 0 else 2.5
    return E.template_gen_gauss(
        x, s.width_a, s.template_background_radius,
        m_exp=s.m_exp, n_exp=s.template_background_exponent,
        mask=mask, truncate_ratio=ratio,
        normalize_near_boundaries=s.normalize_near_boundaries)


def handle_doggxy(s: Settings, x, mask):
    """``HandleDoggXY`` (``handlers_unsupported.cpp:19-160``); with
    -doggxy, width_a[2] is the z sigma."""
    ratio = s.filter_truncate_ratio if s.filter_truncate_ratio > 0 else 2.5
    return E.dogg_xy(x, s.width_a[:2], s.width_b[:2], s.width_a[2],
                     m_exp=s.m_exp, n_exp=s.n_exp, mask=mask,
                     truncate_ratio=ratio)


_FILTER_HANDLERS = {
    S.GAUSS: handle_gauss, S.GGAUSS: handle_ggauss, S.DOG: handle_dog,
    S.DOGG: handle_dogg, S.LOG_DOG: handle_log, S.MEDIAN: handle_median,
    S.LOCAL_FLUCTUATIONS: handle_fluct,
    **dict.fromkeys((S.DILATION, S.EROSION, S.OPENING, S.CLOSING,
                     S.TOP_HAT_WHITE, S.TOP_HAT_BLACK), handle_morphology),
    S.TEMPLATE_GAUSS: handle_template_gauss, S.DOGGXY: handle_doggxy,
}


def _shell_thicknesses(s: Settings, diameters) -> np.ndarray:
    """Each sphere's shell thickness (``handlers.cpp:932-981``)."""
    th = np.full(len(diameters), s.sphere_decals_shell_thickness, float)
    if s.sphere_decals_shell_thickness_is_ratio:
        th = th * diameters
        th[th < s.sphere_decals_shell_thickness_min] = 1.0
    return th


# the Report count of the rows the -blob lists hold
BLOB_ROWS_WRITTEN = "blob lists: rows written"


def handle_blob_detector(s: Settings, x, mask, x_np, mask_np, w, device,
                         rep: Report) -> torch.Tensor:
    """``HandleBlobDetector`` (``handlers.cpp:787-996``): the ladder on
    the card (over the mesh's blocks when ``x`` is sharded), the lists
    written in physical units, the blobs drawn over the input."""
    with stage("blob ladder + extrema + NMS", rep):
        minima, maxima = B.blob_dog_nm(
            x, list(s.blob_diameters), mask=mask,
            aspect_ratio=s.blob_aspect_ratio,
            delta_sigma_over_sigma=s.delta_sigma_over_sigma,
            truncate_ratio=s.filter_truncate_ratio,
            truncate_threshold=s.filter_truncate_threshold,
            minima_threshold=s.score_upper_bound,
            maxima_threshold=s.score_lower_bound,
            use_threshold_ratios=s.score_bounds_are_ratios,
            sep_ratio_thresh=s.nonmax_min_radial_separation_ratio,
            nonmax_max_overlap_large=s.nonmax_max_volume_overlap_large,
            nonmax_max_overlap_small=s.nonmax_max_volume_overlap_small,
            report=rep)
    rep.record_count("blob minima", len(minima))
    rep.record_count("blob maxima", len(maxima))

    def physical(bl):
        return B.BlobList(bl.crds * np.asarray(w)[None, :],
                          bl.diameters * w[0], bl.scores)

    lists = [(fname, bl, order) for fname, bl, order in (
        (s.blob_minima_file_name, minima, B.SORT_INCREASING),
        (s.blob_maxima_file_name, maxima, B.SORT_DECREASING)) if fname]
    if lists and is_writer():
        with stage("write the blob lists", rep):
            for fname, bl, order in lists:
                bl = B.sort_blobs(physical(bl), order, ascending_order=False)
                write_blob_coords_file(fname, bl.crds, bl.diameters,
                                       bl.scores)
            rep.record_count(BLOB_ROWS_WRITTEN,
                             sum(len(bl) for _, bl, _ in lists))

    # annotate spheres over the input image (handlers.cpp:932-981)
    crds = np.concatenate([minima.crds, maxima.crds[::-1]])
    diams = np.concatenate([minima.diameters, maxima.diameters[::-1]])
    scores = np.concatenate([minima.scores, maxima.scores[::-1]])
    shell = _shell_thicknesses(s, diams)
    with stage("draw spheres", rep):
        return D.draw_spheres(
            x_np.shape, crds, diams * s.sphere_decals_scale, shell, scores,
            background=x_np, mask=mask_np,
            background_offset=s.sphere_decals_background,
            background_rescale=s.sphere_decals_background_scale,
            background_normalize=s.sphere_decals_background_norm,
            foreground_normalize=False, device=device, report=rep)


def load_blobs_for_nms(s: Settings, mask_np, w) -> B.BlobList:
    """Shared blob loading for ``-discard-blobs`` / ``-draw-spheres``
    (``handlers.cpp:427-640``)."""
    crds_all, diams_all, scores_all = [], [], []
    for fname in s.in_crds_file_names:
        crds, diams, scores, in_voxels = read_blob_coords_file(
            fname, diameter_override=-1.0,
            score_default=s.sphere_decals_foreground,
            diameter_factor=s.sphere_decals_scale)
        if not in_voxels and w[0] > 0:
            crds = np.floor(crds / w[0] + 0.5)
            diams = np.where(diams != -1.0, diams / w[0], diams)
        if s.sphere_decals_diameter >= 0:
            d = s.sphere_decals_diameter
            if not s.sphere_decals_diameter_in_voxels and w[0] > 0:
                d = d / w[0]
            diams = np.full_like(diams, d)
        crds_all.append(crds)
        diams_all.append(diams)
        scores_all.append(scores)
    blobs = B.BlobList(np.concatenate(crds_all), np.concatenate(diams_all),
                       np.concatenate(scores_all))
    print(" --- discarding blobs in files ---\n", file=sys.stderr)

    if (np.isfinite(s.score_lower_bound) or np.isfinite(s.score_upper_bound)
            or np.isfinite(s.sphere_diameters_lower_bound)
            or np.isfinite(s.sphere_diameters_upper_bound)):
        keep = ((blobs.scores >= s.score_lower_bound)
                & (blobs.scores <= s.score_upper_bound)
                & (blobs.diameters >= s.sphere_diameters_lower_bound)
                & (blobs.diameters <= s.sphere_diameters_upper_bound))
        blobs = blobs.take(keep)

    if len(blobs) and mask_np is not None:
        blobs = B.discard_masked_blobs(blobs, mask_np)

    if (s.nonmax_min_radial_separation_ratio > 0
            or np.isfinite(s.nonmax_max_volume_overlap_large)
            or np.isfinite(s.nonmax_max_volume_overlap_small)):
        if w[0] <= 0:
            raise InputError("overlap check requires -w or an input image")
        blobs = B.discard_overlapping_blobs(
            blobs, s.nonmax_min_radial_separation_ratio,
            s.nonmax_max_volume_overlap_large,
            s.nonmax_max_volume_overlap_small, B.SORT_DECREASING_MAGNITUDE)
    print(f" {len(blobs)} blobs remaining", file=sys.stderr)

    if (s.auto_thresh_score and s.training_pos_crds is not None
            and len(s.training_pos_crds)
            and s.training_neg_crds is not None
            and len(s.training_neg_crds)):
        print("  discarding blobs based on score using training data",
              file=sys.stderr)
        blobs, lo, hi = SUP.discard_blobs_by_score_supervised(
            blobs, s.training_pos_crds, s.training_neg_crds,
            report=sys.stderr)
        print(f" {len(blobs)} blobs remaining", file=sys.stderr)
    return blobs


def handle_blob_nms(s: Settings, mask_np, w) -> B.BlobList:
    """``-discard-blobs``: the filtered list, written in physical units."""
    blobs = load_blobs_for_nms(s, mask_np, w)
    if s.out_crds_file_name and is_writer():
        vw = w[0] if w[0] > 0 else 1.0
        write_blob_coords_file(s.out_crds_file_name, blobs.crds * vw,
                               blobs.diameters * vw, blobs.scores)
    return blobs


def handle_supervised_multi(s: Settings, w) -> None:
    """``HandleBlobScoreSupervisedMulti`` (``handlers.cpp:646-706``) and
    the ``-supervised-multi`` file (each line: pos neg blobs)."""
    blob_lists, pos_lists, neg_lists = [], [], []
    with open(s.supervised_multi_fname) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            pos_f, neg_f, blobs_f = parts[:3]
            pos, pos_vox = read_coordinates(pos_f)
            neg, neg_vox = read_coordinates(neg_f)
            crds, diams, scores, _ = read_blob_coords_file(
                blobs_f, diameter_override=s.sphere_decals_diameter,
                score_default=s.sphere_decals_foreground,
                diameter_factor=s.sphere_decals_scale)
            if w[0] > 0:
                diams = diams / w[0]
                crds = np.floor(crds / w[0] + 0.5)
                if not pos_vox:
                    pos = pos / w[0]
                if not neg_vox:
                    neg = neg / w[0]
            blob_lists.append(B.BlobList(crds, diams, scores))
            pos_lists.append(pos)
            neg_lists.append(neg)
    SUP.choose_blob_score_thresholds_multi(
        blob_lists, pos_lists, neg_lists, report=sys.stderr)


def handle_draw_spheres(s: Settings, x_np, mask_np, w, device,
                        rep: Report) -> torch.Tensor:
    """``HandleDrawSpheres`` (``handlers.cpp:711-780``), drawn on the
    card."""
    blobs = load_blobs_for_nms(s, None, w)  # the mask is not applied here
    scores = blobs.scores.copy()
    if not s.sphere_decals_foreground_use_score:
        scores[:] = s.sphere_decals_foreground
    shell = _shell_thicknesses(s, blobs.diameters)
    # reversed order so earlier (better) blobs paint last
    order = slice(None, None, -1)
    with stage("draw spheres", rep):
        return D.draw_spheres(
            x_np.shape, blobs.crds[order], blobs.diameters[order],
            shell[order], scores[order], background=x_np, mask=mask_np,
            background_offset=s.sphere_decals_background,
            background_rescale=s.sphere_decals_background_scale,
            background_normalize=s.sphere_decals_background_norm,
            foreground_normalize=s.sphere_decals_foreground_norm,
            device=device, report=rep)


def _read_points_vox(s: Settings, w) -> np.ndarray:
    """Coordinate files -> rounded integer voxel coordinates (N, 3) as
    (ix, iy, iz).  IMOD-notation (parenthesized) rows are 1-based voxel
    indices; plain rows are physical units
    (``handlers_unsupported.cpp:1401-1423``)."""
    pts = []
    for fname in s.in_crds_file_names:
        crds, _, _, in_vox = read_blob_coords_file(fname)
        if in_vox:
            crds = crds - 1.0
        elif w[0] > 0:
            crds = crds / np.asarray(w)[None, :]
        pts.append(np.floor(crds + 0.5).astype(np.int64))
    return (np.concatenate(pts, 0) if pts
            else np.zeros((0, 3), np.int64))


def handle_distance_points(s: Settings, x_np, mask_np, w, device,
                           rep: Report) -> torch.Tensor:
    """``HandleDistanceToPoints`` (``handlers_unsupported.cpp:1393-1466``),
    the whole volume on ``device``; masked voxels keep the input."""
    pts = _read_points_vox(s, w)
    vw = w[0] if w[0] > 0 else 1.0
    with stage("distance to points", rep):
        return E.distance_to_points(x_np.shape, pts, vw, mask=mask_np,
                                    background=x_np, device=device)


def handle_distance_to_voxels(s: Settings, x_np, mask_np, w, device,
                              rep: Report) -> np.ndarray:
    """``HandleDistancePointsToFeature``
    (``handlers_unsupported.cpp:1470-1551``): one distance a point,
    written one a line; the image goes on unchanged."""
    pts = _read_points_vox(s, w)
    vw = w[0] if w[0] > 0 else 1.0
    with stage("distance to voxels", rep):
        dists = E.distance_points_to_feature(
            x_np, pts, s.out_thresh_a_value, s.out_thresh_b_value, vw,
            mask=mask_np, device=device)
    if is_writer():
        with open(s.out_distances_file_name, "w") as fh:
            for d in dists:
                fh.write(f"{d}\n")
    return x_np


def handle_random_spheres(s: Settings, x_np, mask_np, w,
                          rep: Report) -> np.ndarray:
    """``HandleRandomSpheres`` (``handlers_unsupported.cpp:1569-1665``),
    on the host: the centres, in physical units, to a file; the
    occupancy image as the output."""
    vw = w[0] if w[0] > 0 else 1.0
    with stage("random spheres", rep):
        centers, occ = E.random_spheres(
            x_np, s.rand_crds_n, s.rand_crds_diameter / vw,
            s.out_thresh_a_value, s.out_thresh_b_value,
            seed=s.rand_crds_seed, mask=mask_np)
    if is_writer():
        with open(s.out_crds_file_name, "w") as fh:
            for ix, iy, iz in centers:
                fh.write(f"{ix * vw} {iy * vw} {iz * vw}\n")
    return occ


def handle_blob_radial_intensity(s: Settings, x_np, mask_np, w,
                                 rep: Report) -> np.ndarray:
    """``HandleBlobRadialIntensity``
    (``handlers_unsupported.cpp:162-455``), on the host: one
    intensity-vs-radius profile file ``<base>_<i>.txt`` a blob; the image
    goes on unchanged."""
    vw = w[0] if w[0] > 0 else 1.0
    crds_all, diams_all = [], []
    for fname in s.in_crds_file_names:
        crds, diams, _, in_vox = read_blob_coords_file(
            fname, diameter_override=s.sphere_decals_diameter,
            score_default=s.sphere_decals_foreground,
            diameter_factor=s.sphere_decals_scale)
        if in_vox:
            crds = crds - 1.0
        else:
            crds = crds / vw
            diams = diams / vw
        crds_all.append(crds)
        diams_all.append(diams)
    crds = np.concatenate(crds_all, 0) if crds_all else np.zeros((0, 3))
    diams = np.concatenate(diams_all, 0) if diams_all else np.zeros(0)
    if mask_np is not None and len(crds):
        keep = []
        nzs, nys, nxs = mask_np.shape
        for i, c in enumerate(crds):
            ix, iy, iz = (int(np.floor(v + 0.5)) for v in c)
            if 0 <= iz < nzs and 0 <= iy < nys and 0 <= ix < nxs \
               and mask_np[iz, iy, ix] != 0:
                keep.append(i)
        crds, diams = crds[keep], diams[keep]
    print(f"  creating intensity-vs-radius profiles for {len(crds)} "
          f"blobs.", file=sys.stderr)
    with stage("blob radial intensity", rep):
        for i in range(len(crds)):
            profile, _ = E.blob_radial_intensity(
                x_np, crds[i], diams[i],
                center_criteria=s.blob_profiles_center_criteria,
                mask=mask_np)
            fname = f"{s.blob_profiles_file_name_base}_{i + 1}.txt"
            if not is_writer():
                continue
            with open(fname, "w") as fh:
                for ir, v in enumerate(profile):
                    fh.write(f"{ir * vw} {v}\n")
    return x_np


def run(argv, device="cuda", report: Optional[Report] = None,
        mesh_devices=None) -> int:
    """Run filter_mrc on ``argv`` with the voxel work on ``device``
    (a library argument, not a flag: the command line always uses
    CUDA).  ``report`` collects the stage timings (default: stderr).
    ``mesh_devices`` lists the devices ``-mesh`` draws its blocks from
    (default: the visible cards; a device may repeat, so a test can
    put several blocks on one card or on the CPU); in a multi-process
    cluster, this rank's devices.  Whatever the path, the run's last
    line is the bytes it copied each way between host and device
    (``Report.format_copies``)."""
    rep = report if report is not None else Report(sys.stderr)
    code = _run(argv, torch.device(device), rep, mesh_devices)
    rep.line(rep.format_copies())
    return code


def _run(argv, device: torch.device, rep: Report, mesh_devices) -> int:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("visfd_tpu_torch: no CUDA device is visible; "
                           "filter_mrc runs its kernels on an NVIDIA GPU")
    s = S.parse_args(list(argv))
    tv_types = (S.SURFACE_RIDGE, S.SURFACE_EDGE, S.CURVE)
    blob_tools = (S.BLOB_NONMAX_SUPPRESSION, S.BLOB_NONMAX_SUPERVISED_MULTI)
    if s.mesh_devices:
        # a multi-process run joins its cluster before the mesh is built
        # (a no-op without VISFD_COORDINATOR / VISFD_NUM_PROCESSES)
        _join_cluster(mesh_devices)
    mesh = _cli_mesh(s, mesh_devices)

    if s.in_file_name:
        print(f'Reading tomogram "{s.in_file_name}"', file=sys.stderr)
        with stage("read the tomogram", rep):
            img = mrc.read_mrc(s.in_file_name)
        img.header.print_stats(sys.stderr)
    elif all(v > 0 for v in s.in_set_image_size):
        nx, ny, nz = s.in_set_image_size
        img = mrc.MrcImage(
            header=mrc.MrcHeader(nvoxels=(nx, ny, nz),
                                 cellA=(float(nx), float(ny), float(nz))),
            data=np.zeros((nz, ny, nx), np.float32))
    elif s.filter_type in blob_tools:
        # the blob tools read only coordinate files
        img = mrc.MrcImage(header=mrc.MrcHeader(),
                           data=np.zeros((0, 0, 0), np.float32))
    else:
        raise InputError("Error: -in (or -image-size) is required")

    mask_np = None
    if s.mask_file_name:
        print(f'Reading mask "{s.mask_file_name}"', file=sys.stderr)
        with stage("read the mask", rep):
            m = mrc.read_mrc(s.mask_file_name)
        if m.data.shape != img.data.shape:
            raise InputError("Error: The size of the mask image does not "
                             "match the size of the input image.")
        mask_np = m.data
        if s.use_mask_select:
            mask_np = np.where(mask_np == s.mask_select, 1.0, 0.0
                               ).astype(np.float32)

    w = determine_voxel_width(s, img)
    s.image_size_orig = img.data.shape
    s.cellA_orig = img.header.cellA

    # binning (explicit or automatic; filter_mrc.cpp:122-210)
    if s.resize_with_binning > 1:
        img, mask_np = handle_binning(s, img, mask_np, w, device, rep)
    elif s.resize_with_binning == 0:
        s.resize_with_binning = 1
        if s.tv_sigma > 0:
            if s.width_a[0] > 1.8 * w[0]:
                s.resize_with_binning = int(np.ceil(s.width_a[0]
                                                    / (1.8 * w[0])))
        elif s.blob_diameters and s.blob_diameters[0] > 15.0 * w[0]:
            s.resize_with_binning = int(np.ceil(s.blob_diameters[0]
                                                / (15.0 * w[0])))
        if s.resize_with_binning > 1:
            print(f"--- BINNING THE IMAGE BY A FACTOR OF "
                  f"{s.resize_with_binning}", file=sys.stderr)
            img, mask_np = handle_binning(s, img, mask_np, w, device, rep)

    if s.mask_regions:
        mask_np = _mask_regions(s, mask_np, img.data.shape, w)

    # unit rescaling (filter_mrc.cpp:290-380)
    s.morphology_r /= w[0]
    s.morphology_rmax /= w[0]
    s.median_radius /= w[0]
    if s.max_distance_to_feature < 0:
        s.max_distance_to_feature /= -w[0]
    else:
        s.max_distance_to_feature /= s.resize_with_binning
    s.tv_sigma /= w[0]
    for d in range(3):
        s.width_a[d] /= w[d]
        s.width_b[d] /= w[d]
        s.log_width[d] /= w[d]
        s.template_background_radius[d] /= w[d]
    s.blob_diameters = [dd / w[0] for dd in s.blob_diameters]
    if not s.sphere_decals_shell_thickness_is_ratio:
        s.sphere_decals_shell_thickness /= w[0]
    else:
        s.sphere_decals_shell_thickness /= s.resize_with_binning
    for attr in ("pos", "neg"):
        crds = getattr(s, f"training_{attr}_crds")
        if crds is not None:
            setattr(s, f"training_{attr}_crds", crds / (
                s.resize_with_binning
                if getattr(s, f"is_training_{attr}_in_voxels") else w[0]))
    if s.must_link_constraints:
        div = s.resize_with_binning if s.is_must_link_in_voxels else w[0]
        s.must_link_constraints = [[tuple(c / div for c in pt) for pt in grp]
                                   for grp in s.must_link_constraints]

    if s.rescale_min_max_in:
        img.rescale01(mask_np, s.in_rescale_min, s.in_rescale_max)

    x_np = img.data
    if s.filter_type == S.NONE:
        print("filter_type = Intensity Map <No convolution filter "
              "specified>", file=sys.stderr)
        out = np.array(x_np, np.float32)
    elif s.filter_type == S.FIND_EXTREMA:
        out = handle_extrema(s, x_np, mask_np, w, device, rep)
    elif s.filter_type == S.WATERSHED:
        out = handle_watershed(s, x_np, mask_np, device, rep, mesh)
    elif s.filter_type == S.LABEL_CONNECTED:
        out = handle_label_connected(s, x_np, mask_np, device, rep, mesh)
    elif s.filter_type == S.BLOB_NONMAX_SUPPRESSION:
        handle_blob_nms(s, mask_np, w)
        return 0
    elif s.filter_type == S.BLOB_NONMAX_SUPERVISED_MULTI:
        handle_supervised_multi(s, w)
        return 0
    elif s.filter_type == S.DRAW_SPHERES:
        out = handle_draw_spheres(s, x_np, mask_np, w, device, rep)
    elif s.filter_type == S.DISTANCE_TO_POINTS:
        out = handle_distance_points(s, x_np, mask_np, w, device, rep)
    elif s.filter_type == S.DISTANCE_TO_VOXELS:
        out = handle_distance_to_voxels(s, x_np, mask_np, w, device, rep)
    elif s.filter_type == S.RANDOM_SPHERES:
        out = handle_random_spheres(s, x_np, mask_np, w, rep)
    elif s.filter_type == S.BLOB_RADIAL_INTENSITY:
        out = handle_blob_radial_intensity(s, x_np, mask_np, w, rep)
    elif s.filter_type in tv_types:
        if min(x_np.shape) < 3:
            print("route: a side below 3 voxels takes the JAX CLI's XLA "
                  "route (visfd_tpu/cli/filter_mrc.py:689-691), whose "
                  "finite differences clamp to the nearest interior voxel "
                  "(visfd_tpu/features/hessian.py:29-33) and raise there",
                  file=sys.stderr)
            raise InputError(f"Error: -membrane/-curve/-edge need at least 3 "
                             f"voxels along every axis (after binning), as in "
                             f"the JAX CLI; got {x_np.shape[::-1]} (x, y, z)")
        out = handle_tv(s, img, x_np, mask_np, w, device, rep, mesh)
    else:
        # the filters and -blob: over the mesh's blocks when it divides
        # the volume
        mesh = _mesh_for(x_np, mesh)
        with stage("copy the volume to the device", rep):
            x = _maybe_shard(x_np, mesh, device, rep)
            mask = _maybe_shard(mask_np, mesh, device, rep)
        dev = x.local_block.device if mesh is not None else device
        rep.record_path("filter", ("cuda" if dev.type == "cuda" else "plain")
                        + ("-sharded" if mesh is not None else ""))
        if s.filter_type == S.BLOB:
            out = handle_blob_detector(s, x, mask, x_np, mask_np, w, dev,
                                       rep)
        else:
            with stage(f"filter {s.filter_type}", rep):
                out = _FILTER_HANDLERS[s.filter_type](s, x, mask)
        del x, mask

    if not s.out_file_name:
        return 0
    if isinstance(out, (torch.Tensor, ShardedVolume)):
        # a collective in a cluster: every rank gathers the whole result
        with stage("copy the result to the host", rep):
            out = to_host_np(out, report=rep)

    if s.invert_output:
        oimg = mrc.MrcImage(header=img.header, data=out)
        oimg.invert(mask_np)
        out = oimg.data

    if s.use_intensity_map:
        out = handle_thresholds(s, out, mask_np, device, rep)

    if mask_np is not None and s.specify_masked_brightness:
        out = np.where(mask_np == 0, s.masked_voxel_brightness, out)

    if s.rescale_min_max_out:
        oimg = mrc.MrcImage(header=img.header,
                            data=np.asarray(out, np.float32))
        oimg.rescale01(mask_np, s.out_rescale_min, s.out_rescale_max)
        out = oimg.data

    # undo automatic binning for TV (handlers.cpp:2320-2355)
    if (s.resize_with_binning != 1 and not s.resize_with_binning_explicit
            and s.filter_type in tv_types):
        with stage("unbin the result", rep):
            out = R.unbin_array3d(
                torch.as_tensor(np.asarray(out, np.float32)),
                s.image_size_orig).numpy()
        img.header.cellA = s.cellA_orig

    hdr = img.header
    if w[0] > 0 and img.data.shape[2]:
        nzo, nyo, nxo = out.shape
        hdr = dataclasses.replace(hdr)
        if not np.isclose(w[0], hdr.cellA[0] / max(nxo, 1)):
            hdr.cellA = (nxo * w[0], nyo * w[1], nzo * w[2])
    if is_writer():
        print("writing tomogram (in 32-bit float mode)", file=sys.stderr)
        with stage("write the tomogram", rep):
            mrc.write_mrc(s.out_file_name, np.asarray(out, np.float32),
                          header=hdr, report=rep)
    else:
        print("skipping tomogram write (process != 0 in a multi-process "
              "run)", file=sys.stderr)
    return 0


def main():
    """Command-line entry: the voxel work runs on the CUDA card; with no
    card visible, ``run`` raises."""
    try:
        return run(sys.argv[1:], device="cuda")
    except (InputError, OSError, ValueError) as e:
        print(f"\n{e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
