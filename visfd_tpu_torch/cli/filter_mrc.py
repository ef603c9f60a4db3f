"""filter_mrc for the PyTorch port: the ``-membrane``/``-curve`` main
path with tensor voting.

Port of the slice of ``visfd_tpu/cli/filter_mrc.py`` that the flagship
run ``filter_mrc -membrane … -tv …`` takes: read -> mask -> voxel
width -> (auto-)binning -> unit rescale -> ``handle_tv`` -> invert /
masked brightness / rescale -> unbin -> write.  ``handle_tv`` runs the
four kernels: Gaussian blur (``ops/blur_cuda``), Hessian + principal
eigensolve + score (``ops/eigen_cuda.hessian_principal``), stick
voting (``ops/tv_cuda``, sparse under ``-tv-best`` <= 0.5) and the
vote tensor's eigen score (``ops/eigen_cuda.sym3_score``).

With ``-mesh N|auto|all`` the volume is split into (z, y) blocks over a
grid of devices (``parallel/mesh``, by default the visible cards) and
``handle_tv`` runs the sharded stages (``parallel/sharded``: halo
exchange, then the per-shard kernels on every block) and the
``-tv-best`` threshold as an exact radix selection over the blocks
(``parallel/reduce``); the output equals the single-device run's.  One
process drives every block: a multi-process cluster (``VISFD_COORDINATOR``
or ``VISFD_NUM_PROCESSES`` set) is refused.

Every flag outside this slice raises ``InputError`` naming it.

Usage: python -m visfd_tpu_torch.cli.filter_mrc -in in.rec -out out.rec
       -w 1 -membrane minima 3 -tv 1.5 [-mesh 4]
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch

from visfd_tpu_torch.cli import settings as S
from visfd_tpu_torch.cli.settings import InputError, Settings
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.ops import filters as F
from visfd_tpu_torch.ops import resample as R
from visfd_tpu_torch.ops.eigen_cuda import hessian_principal, sym3_score
from visfd_tpu_torch.ops.tv_cuda import tv_votes
from visfd_tpu_torch.parallel.gather import to_host_np
from visfd_tpu_torch.parallel.mesh import Mesh, bmap, divides, make_mesh, shard
from visfd_tpu_torch.parallel.reduce import fraction_threshold
from visfd_tpu_torch.parallel.sharded import (
    grid_mesh_of, hessian_principal_sharded, sym3_score_sharded,
    tv_accumulate_sharded)
from visfd_tpu_torch.utils.progress import Report, stage

# The flags this slice handles -> how many arguments follow each
# (None: -rescale-min-max, which takes 0 or 2).
_HANDLED_FLAGS = {
    "-in": 1, "-i": 1, "-out": 1, "-o": 1, "-outf": 1, "-out-force": 1,
    "-mask": 1, "-mask-select": 1, "-mask-out": 1,
    "-w": 1, "-a2nm": 0, "-ang-to-nm": 0, "-bin": 1,
    "-membrane": 2, "-surface-ridge": 2, "-curve": 2,
    "-membrane-background": 1, "-detection-background": 1,
    "-curve-background": 1,
    "-tv": 1, "-tv-angle-exponent": 1, "-tv-truncate-ratio": 1,
    "-tv-best": 1, "-best-visible": 1, "-best": 1,
    "-tv-threshold": 1, "-detection-threshold": 1,
    "-truncate": 1, "-truncate-threshold": 1, "-truncate-thresold": 1,
    "-normalize-filters": 1, "-normalize-near-boundaries": 0,
    "-no-normalize-near-boundaries": 0,
    "-invert": 0, "-inv": 0,
    "-rescale-min-max": None, "-rescale-min-max-in": 0,
    "-mesh": 1,
}

# the variables with which the JAX package joins a multi-process cluster
# (visfd_tpu/parallel/distributed.py)
_CLUSTER_ENV = ("VISFD_COORDINATOR", "VISFD_NUM_PROCESSES")


def _check_flags(argv) -> None:
    """Raise InputError for the first argument this port does not
    handle yet (it never ignores one)."""
    i = 0
    while i < len(argv):
        a = argv[i]
        if a not in _HANDLED_FLAGS:
            raise InputError(
                f"Error: {a} is not handled by visfd_tpu_torch yet (this "
                f"slice runs -membrane/-curve with -tv, -mask and "
                f"binning; see ROADMAP.md)")
        n = _HANDLED_FLAGS[a]
        if n is None:
            try:
                float(argv[i + 1]), float(argv[i + 2])
                n = 2
            except (IndexError, ValueError):
                n = 0
        i += n + 1


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


def _maybe_shard(arr, mesh: Optional[Mesh], device):
    """``arr`` split into the mesh's (z, y) blocks, or whole on
    ``device`` without a mesh."""
    if arr is None:
        return None
    if mesh is None:
        return torch.tensor(arr, dtype=torch.float32, device=device)
    return shard(arr, mesh)


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


def handle_binning(s: Settings, img, mask_img, w, device):
    """``HandleBinning`` (``handlers.cpp:2361-2425``)."""
    nz, ny, nx = img.data.shape
    b = s.resize_with_binning
    new_zyx = (nz // b, ny // b, nx // b)
    vw = s.voxel_width if s.voxel_width > 0 else img.header.cellA[0] / nx
    vw = vw * b

    def binned(a):
        t = torch.tensor(a, dtype=torch.float32, device=device)
        return R.bin_array3d(t, new_zyx).cpu().numpy()

    img.data = binned(img.data)
    img.header.nvoxels = (new_zyx[2], new_zyx[1], new_zyx[0])
    img.header.cellA = tuple(vw * n for n in img.header.nvoxels)
    if mask_img is not None:
        mask_img = binned(mask_img)
    w[:] = vw
    return img, mask_img


def handle_tv(s: Settings, x_np, mask_np, device, rep: Report,
              mesh: Optional[Mesh] = None) -> np.ndarray:
    """``HandleTV`` (``handlers.cpp:1501-2357``) for -membrane and
    -curve: the channel-major kernel path of the JAX CLI, on ``device``
    or, with a ``mesh``, sharded over its (z, y) blocks.  A volume the
    mesh does not divide runs on ``device``, as the JAX CLI leaves it to
    XLA."""
    curve = s.filter_type == S.CURVE
    decreasing = not s.ridges_are_maxima
    sigma = s.width_a[0]
    tr = _truncate_ratio(s)
    if mesh is not None and not divides(x_np.shape, mesh):
        print(f"-mesh: volume {tuple(x_np.shape)} not divisible by the "
              f"{mesh.shape} device grid; sharding axes (None, None)",
              file=sys.stderr)
        mesh = None
    with stage("copy the volume to the device", rep):
        x = _maybe_shard(x_np, mesh, device)
        mask = _maybe_shard(mask_np, mesh, device)
    keep = None if mask is None else bmap(lambda m: m != 0, mask)
    sharded = grid_mesh_of(x) is not None
    on_card = (mesh.devices[0][0] if sharded else device).type == "cuda"
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
        direction = bmap(torch.mul, direction, keep)

    # saliency thresholding (top fraction) -- handlers.cpp:1751-1797
    thr = s.hessian_score_threshold
    if s.hessian_score_threshold_is_a_fraction:
        print(" -- sorting all voxels by ridge saliency --\n",
              file=sys.stderr)
        with stage("-tv-best threshold", rep):
            thr = fraction_threshold(score, thr, mask=mask)
    score = bmap(lambda sc: torch.where(sc < thr, 0.0, sc), score)

    if s.tv_sigma > 0:
        # -tv-best kept only the top fraction of saliencies: the sparse
        # kernel skips the all-zero source planes (feature.hpp:1704-1709)
        tv_sparse = bool(s.hessian_score_threshold_is_a_fraction
                         and float(s.hessian_score_threshold) <= 0.5)
        with stage("dense stick tensor voting", rep):
            if sharded:
                vote, _ = tv_accumulate_sharded(
                    score, direction, mask, s.tv_sigma, s.tv_exponent,
                    curve, s.tv_truncate_ratio, False, sparse=tv_sparse)
            else:
                vote, _ = tv_votes(
                    score, direction, s.tv_sigma, exponent=s.tv_exponent,
                    mask_src=mask, detect_curves=curve,
                    truncate_ratio=s.tv_truncate_ratio, sparse=tv_sparse,
                    channel_major=True, nvec_channel_major=True)
            if keep is not None:
                vote = bmap(lambda v, k: torch.where(k[None], v, 0.0),
                            vote, keep)
            rep.record_path("tv", route + ("-sparse" if tv_sparse
                                           and on_card else ""))
        with stage("eigen score of the vote tensor", rep):
            new_score, _ = vote_score(
                vote, decreasing=decreasing,
                formula="linear" if curve else "stick", want_v=False)
            rep.record_path("vote_eigen", route)
        if background is not None:
            new_score = bmap(lambda sc, v, bg: sc * (v - bg), new_score, x,
                             background)
        if keep is not None:
            new_score = bmap(lambda n, k, sc: torch.where(k, n, sc),
                             new_score, keep, score)
        score = new_score

    rep.line(rep.format_paths())
    with stage("copy the result to the host", rep):
        return to_host_np(score)


def run(argv, device="cuda", report: Optional[Report] = None,
        mesh_devices=None) -> int:
    """Run filter_mrc on ``argv`` with the voxel work on ``device``
    (a library argument, not a flag: the command line always uses
    CUDA).  ``report`` collects the stage timings (default: stderr).
    ``mesh_devices`` lists the devices ``-mesh`` draws its blocks from
    (default: the visible cards; a device may repeat, so a test can
    put several blocks on one card or on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("visfd_tpu_torch: no CUDA device is visible; "
                           "filter_mrc runs its kernels on an NVIDIA GPU")
    _check_flags(argv)
    s = S.parse_args(list(argv))
    if s.mesh_devices and any(v in os.environ for v in _CLUSTER_ENV):
        raise InputError(
            f"Error: -mesh with {' or '.join(_CLUSTER_ENV)} set asks for a "
            f"multi-process run, which visfd_tpu_torch does not run yet: "
            f"one process drives every block (see ROADMAP.md)")
    mesh = _cli_mesh(s, mesh_devices)
    if s.filter_type not in (S.SURFACE_RIDGE, S.CURVE):
        raise InputError("Error: visfd_tpu_torch runs -membrane or -curve "
                         "(with -tv) only so far")
    if not s.in_file_name:
        raise InputError("Error: -in is required")
    rep = report if report is not None else Report(sys.stderr)

    print(f'Reading tomogram "{s.in_file_name}"', file=sys.stderr)
    img = mrc.read_mrc(s.in_file_name)
    img.header.print_stats(sys.stderr)

    mask_np = None
    if s.mask_file_name:
        print(f'Reading mask "{s.mask_file_name}"', file=sys.stderr)
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
        img, mask_np = handle_binning(s, img, mask_np, w, device)
    elif s.resize_with_binning == 0:
        s.resize_with_binning = 1
        if s.tv_sigma > 0 and s.width_a[0] > 1.8 * w[0]:
            s.resize_with_binning = int(np.ceil(s.width_a[0]
                                                / (1.8 * w[0])))
            print(f"--- BINNING THE IMAGE BY A FACTOR OF "
                  f"{s.resize_with_binning}", file=sys.stderr)
            img, mask_np = handle_binning(s, img, mask_np, w, device)

    # unit rescaling (filter_mrc.cpp:290-380), the fields this path reads
    s.tv_sigma /= w[0]
    for d in range(3):
        s.width_a[d] /= w[d]
        s.width_b[d] /= w[d]

    if s.rescale_min_max_in:
        img.rescale01(mask_np, s.in_rescale_min, s.in_rescale_max)

    x_np = img.data
    if min(x_np.shape) < 3:
        raise InputError(f"Error: visfd_tpu_torch needs at least 3 voxels "
                         f"along every axis (after binning), got "
                         f"{x_np.shape[::-1]} (x, y, z)")
    out = handle_tv(s, x_np, mask_np, device, rep, mesh)

    if not s.out_file_name:
        return 0

    if s.invert_output:
        oimg = mrc.MrcImage(header=img.header, data=out)
        oimg.invert(mask_np)
        out = oimg.data

    if mask_np is not None and s.specify_masked_brightness:
        out = np.where(mask_np == 0, s.masked_voxel_brightness, out)

    if s.rescale_min_max_out:
        oimg = mrc.MrcImage(header=img.header,
                            data=np.asarray(out, np.float32))
        oimg.rescale01(mask_np, s.out_rescale_min, s.out_rescale_max)
        out = oimg.data

    # undo automatic binning for TV (handlers.cpp:2320-2355)
    if s.resize_with_binning != 1 and not s.resize_with_binning_explicit:
        out = R.unbin_array3d(torch.as_tensor(np.asarray(out, np.float32)),
                              s.image_size_orig).numpy()
        img.header.cellA = s.cellA_orig

    hdr = img.header
    if w[0] > 0 and img.data.shape[2]:
        nzo, nyo, nxo = out.shape
        hdr = dataclasses.replace(hdr)
        if not np.isclose(w[0], hdr.cellA[0] / max(nxo, 1)):
            hdr.cellA = (nxo * w[0], nyo * w[1], nzo * w[2])
    print("writing tomogram (in 32-bit float mode)", file=sys.stderr)
    mrc.write_mrc(s.out_file_name, np.asarray(out, np.float32), header=hdr)
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
