"""Driver entry points of the port.

Counterparts of the repository's ``__graft_entry__.py``:

* ``entry()`` returns the one-card membrane forward (blur, Hessian
  eigen-analysis and planar score, stick voting, the vote's stick
  score: the four kernels of ``csrc/``) and its example inputs;
* ``dryrun_multichip(n)`` builds an n-block (z, y) mesh and runs the
  JAX dry run's checks on it: the sharded membrane step, the per-shard
  voting against the single-device kernel (sparse against dense), the
  global statistics and the ``-tv-best`` quantile against the host order
  statistic, and the sharded blob ladder, plateau extrema, watershed
  (with markers and boundaries) and ``-connect`` against one device.

Unlike the JAX dry run, the blob ladder runs on a volume the mesh
divides: the port runs an undivided volume on one device rather than
padding it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

SQRT2 = float(np.sqrt(2.0))


def _expect(ok, what: str) -> None:
    """A dry-run check (kept under ``python -O``, unlike ``assert``)."""
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what} does not hold")


def entry(device="cuda"):
    """(forward, args): ``forward(*args)`` is the stick score (Z, Y, X)
    of a seeded (32, 32, 32) volume on ``device``, through the
    unnormalised Gaussian blur (sigma 2), the Hessian x sigma^2 and its
    planar score, dense stick voting (sigma 2, exponent 4) and the
    vote's stick score, as the JAX ``membrane_forward``."""
    from visfd_tpu_torch.ops import kernels as K
    from visfd_tpu_torch.ops.blur_cuda import blur3
    from visfd_tpu_torch.ops.eigen_cuda import hessian_principal, sym3_score
    from visfd_tpu_torch.ops.tv_cuda import tv_votes

    sigma, tv_sigma = 2.0, 2.0
    hw = max(1, int(np.floor(sigma * 2.5)))

    def membrane_forward(x, k1):
        blur = blur3(x, (k1, k1, k1))
        saliency, direction = hessian_principal(blur, sigma, decreasing=True,
                                                formula="planar")
        vote, _ = tv_votes(saliency, direction, tv_sigma, exponent=4,
                           truncate_ratio=SQRT2, channel_major=True,
                           nvec_channel_major=True)
        return sym3_score(vote, decreasing=True, formula="stick")[0]

    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(32, 32, 32)).astype(np.float32), device=device)
    k1 = torch.as_tensor(K.gauss_kernel_1d(sigma, hw), device=device)
    return membrane_forward, (x, k1)


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> None:
    """The JAX ``dryrun_multichip`` on an ``n_devices``-block mesh drawn
    from ``devices`` (default: the visible cards), the single-device
    references on the first; raises AssertionError at the first check
    that fails."""
    from visfd_tpu_torch.features import blob as B
    from visfd_tpu_torch.ops.tv_cuda import tv_votes
    from visfd_tpu_torch.parallel.gather import to_host_np
    from visfd_tpu_torch.parallel.mesh import make_mesh, shard
    from visfd_tpu_torch.parallel.reduce import (
        fraction_threshold, global_min_max_mean, kth_largest)
    from visfd_tpu_torch.parallel.sharded import (
        make_membrane_step, tv_accumulate_sharded)
    from visfd_tpu_torch.parallel.sharded_features import (
        find_extrema_sharded, propagate_watershed_sharded, sharded_blob_dog)
    from visfd_tpu_torch.segment import connect as C
    from visfd_tpu_torch.segment.extrema import find_extrema
    from visfd_tpu_torch.segment.propagate import propagate_watershed

    mesh = make_mesh(n_devices, devices=devices)
    dev = mesh.devices[0][0]
    nz_m, ny_m = mesh.shape
    nz, ny, nx = 4 * nz_m, 4 * ny_m, 16
    xnp = np.random.default_rng(0).normal(size=(nz, ny, nx)).astype(
        np.float32)

    # the sharded membrane step
    step, shard_input = make_membrane_step(
        mesh, sigma=1.0, tv_sigma=1.0, tv_exponent=4, saliency_threshold=0.0)
    stick, vote = step(shard_input(xnp))
    stick_np = to_host_np(stick)
    _expect(stick_np.shape == (nz, ny, nx)
            and to_host_np(vote).shape == (6, nz, ny, nx)
            and np.isfinite(stick_np).all(), "the step's shapes, finite")

    # per-shard voting == the single-device kernel, bit for bit; the
    # sparse mode == the dense one
    rng = np.random.default_rng(7)
    sal = np.abs(rng.normal(size=(nz, ny, nx))).astype(np.float32)
    sal[sal < 0.5] = 0.0
    nvec = rng.normal(size=(3, nz, ny, nx)).astype(np.float32)
    nvec /= np.linalg.norm(nvec, axis=0, keepdims=True)
    want, _ = tv_votes(torch.as_tensor(sal, device=dev),
                       torch.as_tensor(nvec, device=dev), 1.0, exponent=4,
                       truncate_ratio=SQRT2, channel_major=True,
                       nvec_channel_major=True)
    want = want.cpu().numpy()
    for sparse in (False, True):
        got, _ = tv_accumulate_sharded(
            shard(sal, mesh), shard(nvec, mesh, lead=1), None, 1.0, 4, False,
            SQRT2, False, sparse=sparse)
        _expect(np.array_equal(to_host_np(got), want),
                f"per-shard voting (sparse={sparse}) == one device")
    step_sp, _ = make_membrane_step(
        mesh, sigma=1.0, tv_sigma=1.0, tv_exponent=4, saliency_threshold=0.0,
        tv_sparse=True)
    _expect(np.array_equal(to_host_np(step_sp(shard_input(xnp))[0]),
                           stick_np), "the sparse step == the dense step")

    # global statistics and the exact -tv-best quantile
    vmin, vmax, vmean = global_min_max_mean(stick)
    _expect(vmin == stick_np.min() and vmax == stick_np.max()
            and vmin <= vmean <= vmax, "global_min_max_mean")
    thr = fraction_threshold(stick, 0.05)
    k = min(int(np.floor(0.05 * stick_np.size)), stick_np.size - 1)
    _expect(thr == np.sort(stick_np.reshape(-1))[::-1][k]
            and kth_largest(stick, k) == thr, "the -tv-best quantile")

    # the blob ladder == one device
    blob_kw = dict(minima_threshold=0.9, maxima_threshold=0.9,
                   use_threshold_ratios=True)
    xt = torch.as_tensor(xnp, device=dev)
    minima, maxima = sharded_blob_dog(xnp, [1.0, 1.2, 1.44], mesh, **blob_kw)
    ref_min, ref_max = B.blob_dog(xt, [1.0, 1.2, 1.44], **blob_kw)
    for got, ref in ((minima, ref_min), (maxima, ref_max)):
        _expect(len(got) == len(ref) and np.array_equal(got.crds, ref.crds)
                and np.array_equal(got.scores, ref.scores),
                "the blob lists == one device")

    # plateau extrema == one device
    xq = np.round(xnp)
    res = find_extrema_sharded(xq, mesh, connectivity=1)
    ref = find_extrema(torch.as_tensor(xq, device=dev), connectivity=1)
    _expect(res.num_extrema == ref.num_extrema > 0
            and np.array_equal(res.minima_indices, ref.minima_indices)
            and np.array_equal(res.maxima_indices, ref.maxima_indices),
            "the plateau extrema == one device")

    # the steepest-descent watershed, then with markers and Meyer
    # boundaries (the sharded minimax flood), == one device
    ws = propagate_watershed_sharded(xnp, mesh)
    ws_ref = propagate_watershed(xt)
    _expect(ws.num_basins == ws_ref.num_basins and np.array_equal(
        to_host_np(ws.labels), to_host_np(ws_ref.labels)),
        "the watershed == one device")
    mk = np.zeros(xnp.shape, np.int64)
    mk[1, 1, 1] = 4
    mk[nz - 2, ny - 2, 3] = 9
    ws_m = propagate_watershed_sharded(xnp, mesh, markers=mk,
                                       show_boundaries=True)
    ws_mref = propagate_watershed(xt, markers=mk, show_boundaries=True)
    _expect(ws_m.num_basins == ws_mref.num_basins == 2 and np.array_equal(
        to_host_np(ws_m.labels), to_host_np(ws_mref.labels)),
        "the marker watershed with boundaries == one device")

    # -connect over the blocks (gates, seeds, candidate compaction) ==
    # the dense flood on one device
    vec = rng.normal(size=(3,) + xnp.shape).astype(np.float32)
    tens = rng.normal(size=(6,) + xnp.shape).astype(np.float32)
    conn_kw = dict(
        threshold_saliency=0.5, threshold_vector_saliency=-0.5,
        threshold_vector_neighbor=0.2, consider_dot_product_sign=False,
        threshold_tensor_saliency=-0.5, threshold_tensor_neighbor=-0.2,
        connectivity=1, standardize_vector_sign=True)
    r_mesh = C.label_connected(shard(xnp, mesh), vector=shard(vec, mesh,
                                                               lead=1),
                               tensor=shard(tens, mesh, lead=1), **conn_kw)
    r_ref = C.label_connected(xt, vector=torch.as_tensor(vec, device=dev),
                              tensor=torch.as_tensor(tens, device=dev),
                              compact=False, **conn_kw)
    _expect(r_mesh.num_clusters == r_ref.num_clusters
            and np.array_equal(r_mesh.labels, r_ref.labels),
            "-connect over the blocks == the dense flood")
