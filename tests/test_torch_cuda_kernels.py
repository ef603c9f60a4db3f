"""The port's CUDA kernels and card paths against their plain twins.

Imports torch and the port only (no jax), so the file runs where the
card is, which has no jax; tests/conftest.py imports jax, so there it
runs without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Every case carries the ``cuda`` marker and skips without a card.  The
inputs are small seeded volumes whose sides differ; the tolerances are
chip_smoke.py's: the blur rtol 1e-5 / atol 1e-6 of the largest value,
the eigen scores rtol 1e-5 / atol 1e-6 (planar) or 1e-4 / 1e-5, the
principal vectors |v.v'| > 1 - 1e-4 where the eigenvalue is separated,
the voting rtol 2e-4 / atol 2e-5, sparse voting against dense rtol 3e-7;
the per-shard kernels and every label exactly.
"""

import numpy as np
import pytest
import torch

from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.convert import to_numpy, to_torch
from visfd_tpu_torch.features import blob as TB
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.ops import conv, eigen_cuda as EC
from visfd_tpu_torch.ops import kernels as K
from visfd_tpu_torch.ops.blur_cuda import blur3, blur3_plain
from visfd_tpu_torch.ops.filters import apply_gauss
from visfd_tpu_torch.ops.tv_cuda import tv_votes
from visfd_tpu_torch.parallel import sharded as TSH
from visfd_tpu_torch.parallel.gather import to_host_np
from visfd_tpu_torch.parallel.mesh import divides, make_mesh, shard
from visfd_tpu_torch.parallel.sharded_features import (
    find_extrema_sharded, propagate_watershed_sharded, sharded_blob_dog)
from visfd_tpu_torch.segment import connect as TC
from visfd_tpu_torch.segment import extrema as TE
from visfd_tpu_torch.segment.propagate import propagate_watershed
from visfd_tpu_torch.segment.watershed import watershed
from visfd_tpu_torch.utils.phantom import blob_phantom, membrane_phantom
from visfd_tpu_torch.utils.progress import Report

pytestmark = pytest.mark.cuda

SIGMA = 1.7
RATIO = float(np.sqrt(2.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest "
                    "tests/test_torch_cuda_kernels.py on one")
    return torch.device("cuda")


def _rng(seed):
    return np.random.default_rng(seed)


# --- blur ------------------------------------------------------------------

# an asymmetric kernel set: a flipped (correlation instead of
# convolution) blur would pass every check with a Gaussian
ASYM = (np.array([0.1, 0.5, 0.25, 0.1, 0.05], np.float32),
        np.array([0.6, 0.3, 0.1], np.float32),
        np.array([0.05, 0.1, 0.15, 0.2, 0.3, 0.15, 0.05], np.float32))


def _close_blur(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(12, 20, 33), (3, 70, 1030),
                                   (70, 2, 41), (300, 5, 40)])
@pytest.mark.parametrize("hws", [(60, 60, 60), (80, 57, 3), (120, 30, 200),
                                 (55, 55, 55), (55, 60, 80)])
def test_blur3_axis_mode_matches_twin(cuda, hws, shape):
    """The per-axis mode (halfwidths no fused tile holds, taps reaching
    far past the volume, a side of 2, a z line of two chunks of taps)
    against blur3_plain; blur3 takes it by shape alone, and it counts its
    own launches.  A haloed block's interior equals the whole volume's
    bits."""
    from visfd_tpu_torch.ops import blur_cuda
    rng = _rng(8)
    x = rng.normal(size=shape).astype(np.float32)
    ks = [rng.uniform(0.1, 1.0, 2 * h + 1).astype(np.float32) for h in hws]
    assert blur_cuda.smem_plan(*hws) is None
    n0, a0 = blur_cuda.blur3.launches, blur_cuda.blur3_axis.launches
    got = blur3(torch.tensor(x, device=cuda), ks)
    torch.cuda.synchronize()
    assert blur_cuda.blur3.launches == n0
    assert blur_cuda.blur3_axis.launches == a0 + 3
    _close_blur(got.cpu(), blur3_plain(torch.tensor(x),
                                       [torch.tensor(k) for k in ks]))
    hx, hy, hz = hws
    sub, (z0, z1, y0, y1) = _haloed_block(x, hz, hy)
    blk = blur3(torch.tensor(sub, device=cuda), ks).cpu().numpy()
    assert np.array_equal(blk[hz:hz + z1 - z0, hy:hy + y1 - y0],
                          got.cpu().numpy()[z0:z1, y0:y1])


def test_blur3_axis_mode_equals_fused_kernel(cuda):
    """At a halfwidth both take, the per-axis mode sums each voxel's
    taps in the fused kernel's order: equal values."""
    from visfd_tpu_torch.ops import blur_cuda
    rng = _rng(9)
    x = torch.tensor(rng.normal(size=(40, 50, 70)).astype(np.float32),
                     device=cuda)
    ks = [torch.tensor(rng.uniform(0.1, 1.0, 2 * h + 1).astype(np.float32),
                       device=cuda) for h in (12, 20, 9)]
    a = blur_cuda.blur3(x, ks)
    b = blur_cuda.blur3_axis(x, ks)
    np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(), rtol=1e-6,
                               atol=1e-7 * float(a.abs().max()))


@pytest.mark.parametrize("shape", [(12, 20, 33), (40, 70, 68),
                                   (3, 100, 1030), (70, 2, 44)])
@pytest.mark.parametrize("hw", [6, 8, 9, 10])
def test_blur3_wide_instance_equals_runtime_instance(cuda, hw, shape):
    """The wide instance sums every voxel's taps as the runtime one does:
    equal bits with rows of 16 bytes and without, ragged tiles, a side
    of 2, a volume thinner than the halo; a haloed block's interior
    equals the whole volume's bits."""
    from visfd_tpu_torch.ops import blur_cuda
    rng = _rng(11)
    x = rng.normal(size=shape).astype(np.float32)
    ks = [to_torch(rng.uniform(-1.0, 1.0, 2 * hw + 1).astype(np.float32),
                   cuda) for _ in range(3)]
    xc = to_torch(x, cuda)
    w0 = blur_cuda.blur3.wide_launches
    got = blur3(xc, ks)
    assert blur_cuda.blur3.wide_launches == w0 + 1
    want = blur_cuda.blur3_fused(xc, ks, "runtime")
    g = got.cpu().numpy()
    assert np.array_equal(g, want.cpu().numpy())
    sub, (z0, z1, y0, y1) = _haloed_block(x, hw, hw)
    blk = blur3(to_torch(sub, cuda), ks).cpu().numpy()
    assert np.array_equal(blk[hw:hw + z1 - z0, hw:hw + y1 - y0],
                          g[z0:z1, y0:y1])


def _haloed_block(x, hz, hy):
    """(the block of planes z0:z1 and rows y0:y1 of x, its middle half,
    read with a halo hz planes and hy rows deep, zeros beyond the
    volume; (z0, z1, y0, y1))."""
    nz, ny, nx = x.shape
    z0, y0 = (nz + 2) // 4, (ny + 2) // 4
    z1, y1 = max(z0 + 1, nz - z0), max(y0 + 1, ny - y0)
    sub = np.zeros((z1 - z0 + 2 * hz, y1 - y0 + 2 * hy, nx), np.float32)
    lo_z, lo_y = max(0, z0 - hz), max(0, y0 - hy)
    hi_z, hi_y = min(nz, z1 + hz), min(ny, y1 + hy)
    sub[lo_z - (z0 - hz):hi_z - (z0 - hz), lo_y - (y0 - hy):hi_y - (y0 - hy)] \
        = x[lo_z:hi_z, lo_y:hi_y]
    return sub, (z0, z1, y0, y1)


# (hx, hy, hz): every compiled instance of csrc/conv3d.cu (3^3, 5^3, 7^3,
# 15^3, (1, 21, 21), 31^3), the runtime one with its taps in shared
# memory (sides of 1 among them, a row longer than the tile), with its
# taps through L1 (41^3), and in bands of kernel rows ((1, 241, 241))
@pytest.mark.parametrize("hs", [(1, 1, 1), (2, 2, 2), (3, 3, 3), (7, 7, 7),
                                (10, 10, 0), (15, 15, 15), (3, 2, 4),
                                (5, 5, 5), (0, 6, 2), (120, 0, 0),
                                (20, 20, 20), (120, 120, 0)])
@pytest.mark.parametrize("shape", [(9, 21, 45), (5, 7, 130), (1, 13, 1)])
def test_conv3d_dense_kernel_matches_twin(cuda, hs, shape):
    """The dense correlation kernel against its shift-sum twin (an
    asymmetric kernel, sides that differ and are no multiple of the
    tile, volumes thinner than the kernel, a side of 1, NaN in the
    input), and a haloed block's interior equal to the whole volume's
    bit for bit."""
    from visfd_tpu_torch.ops import dense_cuda as DC
    rng = _rng(10)
    hx, hy, hz = hs
    x = rng.normal(size=shape).astype(np.float32)
    x[tuple(n // 2 for n in shape)] = np.nan
    k = rng.normal(size=(2 * hz + 1, 2 * hy + 1, 2 * hx + 1)).astype(
        np.float32)
    plan = DC.dense_plan(k.shape)
    assert (plan.variant > 0) == (k.shape in DC.COMPILED)
    n0 = DC.conv3d_dense.launches
    got = DC.conv3d_dense(torch.tensor(x, device=cuda), k)
    torch.cuda.synchronize()
    assert DC.conv3d_dense.launches == n0 + 1
    want = DC.conv3d_dense_plain(torch.tensor(x), torch.tensor(k)).numpy()
    g = got.cpu().numpy()
    assert np.array_equal(np.isnan(g), np.isnan(want))
    fin = np.isfinite(want)
    if fin.any():  # a volume the kernel spans has NaN everywhere
        np.testing.assert_allclose(g[fin], want[fin], rtol=1e-5,
                                   atol=1e-6 * np.abs(want[fin]).max())
    sub, (z0, z1, y0, y1) = _haloed_block(x, hz, hy)
    blk = DC.conv3d_dense(torch.tensor(sub, device=cuda), k).cpu().numpy()
    inner = blk[hz:hz + z1 - z0, hy:hy + y1 - y0]
    assert np.array_equal(inner, g[z0:z1, y0:y1], equal_nan=True)


@pytest.mark.parametrize("field", ["normal", "top5"])
@pytest.mark.parametrize("hw", [4, 5, 6, 7, 8, 9, 10, (9, 10, 9)])
def test_blur3_cuda_kernel_matches_twin(cuda, hw, field):
    """Each instance against the twin: 4 (ASYM's uneven widths) the
    runtime one, 5 a compiled one, 6-10 the wide one, (9, 10, 9) (hx, hy,
    hz) the runtime one; the wide launches are counted."""
    from visfd_tpu_torch.ops import blur_cuda
    rng = _rng(4)
    x = rng.normal(size=(12, 20, 33)).astype(np.float32)
    mask = (rng.uniform(size=x.shape) > 0.3).astype(np.float32)
    if field == "top5":  # scattered, as -tv-best 0.05 leaves a field
        x = np.where(x >= np.quantile(x, 0.95), x, 0.0).astype(np.float32)
    hws = hw if isinstance(hw, tuple) else (hw,) * 3
    ks = ASYM if hw == 4 else tuple(K.gauss_kernel_1d(2.0, h)
                                    for h in hws)
    kind = blur_cuda.instance(*(len(k) // 2 for k in ks))
    assert kind == ("wide" if hw in (6, 7, 8, 9, 10) else
                    "compiled" if hw == 5 else "runtime")
    xc = to_torch(x, cuda)
    n0, w0 = blur_cuda.blur3.launches, blur_cuda.blur3.wide_launches
    got = blur3(xc, ks)
    torch.cuda.synchronize()
    assert blur_cuda.blur3.launches == n0 + 1
    assert blur_cuda.blur3.wide_launches == w0 + (kind == "wide")
    want = blur3_plain(xc, [to_torch(k, cuda) for k in ks])
    _close_blur(to_numpy(got), to_numpy(want))
    got_m = conv.separable_conv3d(xc, ks, mask=to_torch(mask, cuda))
    want_m = conv.separable_conv3d(to_torch(x), ks, mask=to_torch(mask))
    _close_blur(to_numpy(got_m), to_numpy(want_m))


# --- the eigen kernels -----------------------------------------------------

@pytest.fixture(scope="module")
def blur():
    return _rng(0).normal(size=(12, 20, 33)).astype(np.float32)


def _close_eigen(got, want, formula):
    rtol, atol = (1e-5, 1e-6) if formula == "planar" else (1e-4, 1e-5)
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * np.abs(want).max())


def _same_direction(v, v_ref, vals):
    """|v . v_ref| ~ 1 where the principal eigenvalue is separated;
    channel-last (..., 3) fields, vals (..., 3) in solver order."""
    gap = np.abs(vals[..., 0] - vals[..., 1])
    well = gap > 1e-3 * np.abs(vals).max()
    assert well.mean() > 0.95
    assert np.abs((v * v_ref).sum(-1))[well].min() > 1 - 1e-4


def _block_and_halos(x, z0, y0, bz, by):
    """The (bz, by, X) block of ``x`` at (z0, y0) and its four 1-deep
    halo slabs, cut from the volume zero-padded in z and y."""
    p = np.pad(x, ((1, 1), (1, 1), (0, 0)))
    z, y = z0 + 1, y0 + 1
    parts = (p[z:z + bz, y:y + by], p[z - 1, y - 1:y + by + 1],
             p[z + bz, y - 1:y + by + 1], p[z:z + bz, y - 1],
             p[z:z + bz, y + by])
    return [to_torch(np.ascontiguousarray(a)) for a in parts]


@pytest.mark.parametrize("formula", ["planar", "linear", "stick", "vals"])
def test_hessian_block_cuda_matches_twin(cuda, blur, formula):
    """The per-shard kernel against its twin, on a block inside the
    volume and on one at its corner (zero halos), both orders, with and
    without the vector."""
    for (z0, y0, bz, by), decreasing in (((4, 6, 5, 9), True),
                                         ((0, 0, 7, 3), False)):
        parts = _block_and_halos(blur, z0, y0, bz, by)
        vals = to_numpy(EC.hessian_principal_block(
            *parts, SIGMA, decreasing, "vals", False), channels_last=True)
        want = EC.hessian_principal_block(*parts, SIGMA, decreasing, formula,
                                          True)
        ns = 3 if formula == "vals" else 1
        for want_v in (True, False):
            got = EC.hessian_principal_block(*[p.to(cuda) for p in parts],
                                             SIGMA, decreasing, formula,
                                             want_v)
            assert got.shape[0] == ns + (3 if want_v else 0)
            _close_eigen(to_numpy(got[:ns]), to_numpy(want[:ns]), formula)
            if want_v:
                _same_direction(to_numpy(got[ns:], channels_last=True),
                                to_numpy(want[ns:], channels_last=True),
                                vals)


@pytest.mark.parametrize("formula", ["planar", "linear", "stick", "vals"])
def test_eigen_cuda_kernels_match_twins(cuda, blur, formula):
    for decreasing in (True, False):
        got = EC.hessian_principal(to_torch(blur, cuda), SIGMA,
                                   decreasing=decreasing, formula=formula,
                                   want_v=True)
        want = EC.hessian_principal(to_torch(blur), SIGMA,
                                    decreasing=decreasing, formula=formula,
                                    want_v=True)
        _close_eigen(to_numpy(got[0]), to_numpy(want[0]), formula)
        vals = to_numpy(EC.hessian_principal(
            to_torch(blur), SIGMA, decreasing=decreasing, formula="vals",
            want_v=False)[0], channels_last=True)
        _same_direction(to_numpy(got[1], channels_last=True),
                        to_numpy(want[1], channels_last=True), vals)
    t6 = _rng(7).normal(size=(6, 9, 17, 40)).astype(np.float32)
    got = EC.sym3_score(to_torch(t6, cuda), formula=formula, want_v=True)
    want = EC.sym3_score(to_torch(t6), formula=formula, want_v=True)
    _close_eigen(to_numpy(got[0]), to_numpy(want[0]), formula)


# --- voting ----------------------------------------------------------------

TV_SHAPE = (12, 20, 36)
TV_CASES = {
    # name: (hw, exponent, curves, masked, nvec channel-major)
    "hw1_e2": (1, 2, False, False, False),
    "hw2_e3_cm": (2, 3, False, False, True),
    "hw3_e4_sparse": (3, 4, False, False, False),
    "hw2_e4_mask_den": (2, 4, False, True, True),
    "hw2_e4_curves": (2, 4, True, False, False),
}


def _tv_inputs(field):
    rng = _rng(21)
    sal = rng.uniform(0, 1, size=TV_SHAPE).astype(np.float32)
    sal[sal > 0.05] = 0.0
    v = rng.normal(size=TV_SHAPE + (3,)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    mask = (rng.uniform(size=TV_SHAPE) > 0.25).astype(np.float32)
    if field == "top5":   # the top 5% of a random score
        score = _rng(22).normal(size=TV_SHAPE).astype(np.float32)
        sal = np.where(score >= np.quantile(score, 0.95), score,
                       0.0).astype(np.float32)
    return sal, v, mask


@pytest.mark.parametrize("field", ["uniform", "top5"])
@pytest.mark.parametrize("case", list(TV_CASES))
def test_tv_cuda_kernel_matches_twin(cuda, case, field):
    hw, e, curves, masked, cm = TV_CASES[case]
    sal, v, mask = _tv_inputs(field)
    nv = np.moveaxis(v, -1, 0) if cm else v
    sigma = hw / RATIO + 1e-6   # floor(sigma * sqrt(2)) == hw
    kw = dict(exponent=e, detect_curves=curves, truncate_ratio=RATIO,
              want_denominator=masked, channel_major=True,
              nvec_channel_major=cm)
    want, want_den = tv_votes(to_torch(sal), to_torch(nv), sigma,
                              mask_src=to_torch(mask) if masked else None,
                              **kw)
    outs = []
    for sparse in (False, True):
        got, got_den = tv_votes(
            to_torch(sal, cuda), to_torch(nv, cuda), sigma,
            mask_src=to_torch(mask, cuda) if masked else None,
            sparse=sparse, **kw)
        torch.cuda.synchronize()
        np.testing.assert_allclose(to_numpy(got), to_numpy(want),
                                   rtol=2e-4, atol=2e-5)
        if masked:
            np.testing.assert_allclose(to_numpy(got_den), to_numpy(want_den),
                                       rtol=2e-4, atol=2e-5)
        outs.append(to_numpy(got))
    np.testing.assert_allclose(outs[1], outs[0], rtol=3e-7, atol=0)


# --- the blob ladder's extremum test ---------------------------------------

# sides that are not multiples of the 32 x 32 x 32 tile, z over 2 tiles
EXTREMUM_SHAPES = [(1, 5, 5), (3, 17, 33), (7, 33, 65), (40, 70, 45),
                   (70, 40, 36)]


def _extremum_inputs(shape, seed, field):
    """Three scales and a mask with holes (boxes and single voxels; a few
    non-binary and NaN mask values, which count as inside): ``normal`` noise, ``quantised`` noise
    (ties within and across scales) or ``nan`` (NaNs in each scale);
    clear extrema planted on the volume's faces (never candidates: a
    neighbour lies outside) and one voxel inside each face."""
    rng = _rng(seed)
    p, m, n = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    if field == "quantised":
        p, m, n = (np.round(a * 2).astype(np.float32) / 2 for a in (p, m, n))
    nz, ny, nx = shape
    c = (nz // 2, ny // 2, nx // 2)
    for k, (ax, at) in enumerate((a, t) for a in range(3)
                                 for t in (0, shape[a] - 1, 1,
                                           shape[a] - 2)):
        zyx = list(c)
        zyx[ax] = min(max(at, 0), shape[ax] - 1)
        zyx[(ax + 1) % 3] = (zyx[(ax + 1) % 3] + k) % shape[(ax + 1) % 3]
        m[tuple(zyx)] = 9.0 if k % 2 else -9.0
    if field == "nan":
        for a in (p, m, n):
            a[rng.uniform(size=shape) < 0.02] = np.nan
    mask = (rng.uniform(size=shape) > 0.005).astype(np.float32)
    for _ in range(3):
        lo = [int(rng.integers(0, s)) for s in shape]
        mask[tuple(slice(a, a + max(1, s // 3)) for a, s in zip(lo, shape))] = 0
    mask[rng.uniform(size=shape) < 0.02] = 0.5
    mask.flat[rng.integers(0, mask.size)] = np.nan
    return p, m, n, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("field", ["normal", "quantised", "nan"])
@pytest.mark.parametrize("shape", EXTREMUM_SHAPES)
def test_blob_extremum_kernel_matches_twin(cuda, shape, field, masked,
                                           monkeypatch):
    """The kernel's codes equal the twin's masks with the sign test, and
    ``_scale_candidates`` on the card (one launch over the volume; a
    (2, 2) mesh's slab windows where it divides the volume) gives the
    CPU's candidates and scores exactly."""
    p, m, n, mask = _extremum_inputs(shape, sum(shape), field)
    k = mask if masked else None
    cpu = [torch.tensor(a) for a in (p, m, n)]
    lo, hi = TB._extremum_masks(*cpu, None if k is None else torch.tensor(k))
    want = ((lo & (cpu[1] < 0)).to(torch.uint8)
            | ((hi & (cpu[1] > 0)).to(torch.uint8) << 1)).numpy()
    card = [torch.tensor(a, device=cuda) for a in (p, m, n)]
    kc = None if k is None else torch.tensor(k, device=cuda)
    valid = None if kc is None else (kc != 0).view(torch.uint8)
    got = TB._extremum_codes_cuda(*card, valid)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if shape[0] >= 3 and field == "normal":
        assert (want == 1).any() and (want == 2).any()

    ref = TB._scale_candidates(*cpu, None if k is None else torch.tensor(k))
    rep = Report(None)
    for part, w in zip(TB._scale_candidates(*card, kc, rep), ref):
        np.testing.assert_array_equal(part[0], w[0])
        np.testing.assert_array_equal(part[1], w[1])
    assert rep.counts[TB.KERNEL_LAUNCHES] == 1
    assert TB.TWIN_SLABS not in rep.counts
    mesh = make_mesh(4, devices=[cuda] * 4)
    if divides(shape, mesh):
        # several slabs a block, so windows start inside blocks too
        monkeypatch.setattr(TB, "SLAB_VOXELS", 3 * shape[1] * shape[2] // 2)
        vols = [shard(a, mesh) for a in (p, m, n)]
        rep = Report(None)
        got_m = TB._scale_candidates(
            *vols, None if k is None else shard(k, mesh), rep)
        for part, w in zip(got_m, ref):
            np.testing.assert_array_equal(part[0], w[0])
            np.testing.assert_array_equal(part[1], w[1])
        assert rep.counts[TB.KERNEL_LAUNCHES] == 4 * -(-(shape[0] // 2) // 3)


# --- the -mesh kernels -----------------------------------------------------

def test_sharded_kernels_equal_single_on_card(cuda):
    """On one card with a (2, 2) mesh: the per-shard kernels give the
    single-device kernels' floats exactly."""
    mesh = make_mesh(4, devices=[cuda] * 4)
    shape = (32, 40, 48)
    rng = _rng(13)
    sal = rng.uniform(0, 1, size=shape).astype(np.float32)
    sal[sal < 0.4] = 0.0
    v = rng.normal(size=(3,) + shape).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    mask = (rng.uniform(size=shape) > 0.25).astype(np.float32)
    s_t, v_t, m_t = (torch.as_tensor(a, device=cuda) for a in (sal, v, mask))
    want, want_den = tv_votes(s_t, v_t, 1.5, mask_src=m_t,
                              want_denominator=True, truncate_ratio=RATIO,
                              channel_major=True, nvec_channel_major=True)
    got, got_den = TSH.tv_accumulate_sharded(
        shard(sal, mesh), shard(v, mesh, lead=1), shard(mask, mesh), 1.5, 4,
        False, RATIO, True, sparse=True)
    assert np.array_equal(to_host_np(got), want.cpu().numpy())
    assert np.array_equal(to_host_np(got_den), want_den.cpu().numpy())
    ws, wv = EC.hessian_principal(s_t, 1.5)
    gs, gv = TSH.hessian_principal_sharded(shard(sal, mesh), 1.5)
    assert np.array_equal(to_host_np(gs), ws.cpu().numpy())
    assert np.array_equal(to_host_np(gv), wv.cpu().numpy())
    ss, sv = EC.sym3_score(want, want_v=True)
    gs, gv = TSH.sym3_score_sharded(got, want_v=True)
    assert np.array_equal(to_host_np(gs), ss.cpu().numpy())
    assert np.array_equal(to_host_np(gv), sv.cpu().numpy())
    # the blob ladder: the blocks' windows through the extremum kernel
    x, slab, _, _ = blob_phantom(shape, seed=13, n_blobs=14, spacing=16,
                                 diameters=(6.0, 9.0))
    sig = [5.0 * 1.1 ** i / (2 * np.sqrt(3.0)) for i in range(8)]
    kw = dict(minima_threshold=0.0, maxima_threshold=0.0,
              use_threshold_ratios=False)
    for m in (None, slab):
        one = TB.blob_dog(x.to(cuda), sig, mask=None if m is None
                          else m.to(cuda), **kw)
        got_b = sharded_blob_dog(x.numpy(), sig, mesh, mask=None if m is None
                                 else m.numpy(), **kw)
        for a, b in zip(got_b, one):
            assert len(b) > 5
            np.testing.assert_array_equal(a.crds, b.crds)
            np.testing.assert_array_equal(a.diameters, b.diameters)
            np.testing.assert_array_equal(a.scores, b.scores)


# --- the CLI and the segmentation on the card ------------------------------

def test_cli_card_matches_cpu(cuda, tmp_path):
    """The CLI with its CUDA kernels against the CLI with the twins
    (dense voting), to the TV tolerance."""
    vol, _ = membrane_phantom((20, 28, 40), seed=3, thickness=2.5)
    mrc.write_mrc(str(tmp_path / "in.mrc"), vol.numpy())
    outs = []
    for dev in (cuda, "cpu"):
        out = tmp_path / f"card_{torch.device(dev).type}.mrc"
        assert TFM.run(f"-in {tmp_path}/in.mrc -out {out} -w 1 -membrane "
                       f"minima 2.5 -tv 1.0 -tv-best 1.0".split(),
                       device=dev, report=Report(None)) == 0
        outs.append(mrc.read_mrc(str(out)).data)
    a, b = outs[1], outs[0]
    assert np.isclose(b, a, rtol=2e-4, atol=2e-5 * np.abs(a).max()).all()


def _smooth(shape, seed, sigma=1.5):
    x = torch.tensor(_rng(seed).normal(size=shape).astype(np.float32))
    return apply_gauss(x, sigma).numpy()


def test_label_connected_card_matches_cpu(cuda):
    """Gates, seeds and compaction on the card (one device and a (2, 2)
    mesh of blocks on it) give the CPU's labels."""
    shape = (12, 14, 17)
    rng = _rng(5)
    sal = _smooth(shape, 5)
    t6 = rng.normal(size=(6,) + shape).astype(np.float32)
    v3 = rng.normal(size=(3,) + shape).astype(np.float32)
    mask = (rng.uniform(size=shape) > 0.1).astype(np.float32)
    kw = dict(threshold_saliency=float(np.percentile(sal, 75)),
              threshold_tensor_saliency=0.3, threshold_vector_saliency=0.2,
              threshold_tensor_neighbor=0.1, threshold_vector_neighbor=0.4,
              consider_dot_product_sign=False, standardize_vector_sign=True)
    want = TC.label_connected(torch.tensor(sal), mask=torch.tensor(mask),
                              tensor=torch.tensor(t6),
                              vector=torch.tensor(v3), **kw)
    got = TC.label_connected(*(torch.tensor(a, device=cuda)
                               for a in (sal,)), mask=torch.tensor(
        mask, device=cuda), tensor=torch.tensor(t6, device=cuda),
        vector=torch.tensor(v3, device=cuda), **kw)
    np.testing.assert_array_equal(got.labels, want.labels)
    mesh = make_mesh(4, devices=[cuda] * 4)
    meshed = TC.label_connected(
        shard(sal, mesh), mask=shard(mask, mesh),
        tensor=shard(t6, mesh, lead=1), vector=shard(v3, mesh, lead=1), **kw)
    np.testing.assert_array_equal(meshed.labels, got.labels)


@pytest.mark.parametrize("kind", ["smooth", "integers"])
def test_segmentation_card_matches_cpu(cuda, kind):
    """find_extrema, the host flood's seeds and the device watershed
    (one device and a (2, 2) mesh on the card) against the CPU: equal
    lists and labels."""
    x = _smooth((16, 20, 23), 9)
    if kind == "integers":
        x = np.round(x * 4).astype(np.float32)
    mask = (_rng(10).uniform(size=x.shape) > 0.1).astype(np.float32)
    xc, mc = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    a = TE.find_extrema(xc, mask=mc)
    b = TE.find_extrema(torch.tensor(x), mask=torch.tensor(mask))
    mesh = make_mesh(4, devices=[cuda] * 4)
    c = find_extrema_sharded(x, mesh, mask=mask)
    for f in ("minima_indices", "minima_scores", "maxima_indices",
              "maxima_scores", "label_image"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(getattr(c, f), getattr(b, f))
    kw = dict(mask=mask, show_boundaries=True)
    np.testing.assert_array_equal(watershed(xc, **kw).labels,
                                  watershed(x, **kw).labels)
    want = propagate_watershed(x, **kw).labels.numpy()
    np.testing.assert_array_equal(
        propagate_watershed(xc, mask=mc, show_boundaries=True)
        .labels.cpu().numpy(), want)
    np.testing.assert_array_equal(
        to_host_np(propagate_watershed_sharded(x, mesh, **kw).labels), want)


# --- the z pass, the 2-D dense mode, the experimental filters -------------

@pytest.mark.parametrize("hyx", [(1, 1), (3, 2), (0, 3)])
@pytest.mark.parametrize("masked,normalize", [(False, False), (True, False),
                                              (True, True)])
def test_conv3d_dense_2d_mode_matches_twin(cuda, hyx, masked, normalize):
    """The dense kernel with a (1, Ky, Kx) kernel (ops/filter2d.dense_conv2d)
    against its twin on the CPU: each z slice correlated on its own, one
    launch a correlation."""
    from visfd_tpu_torch.ops import dense_cuda as DC
    from visfd_tpu_torch.ops import filter2d as F2
    rng = _rng(81)
    hy, hx = hyx
    x = rng.normal(size=(7, 19, 37)).astype(np.float32)
    m = (rng.uniform(size=x.shape) > 0.3).astype(np.float32) if masked \
        else None
    k = np.abs(rng.normal(size=(2 * hy + 1, 2 * hx + 1))).astype(np.float32)
    n0 = DC.conv3d_dense.launches
    got = F2.dense_conv2d(torch.tensor(x, device=cuda), k,
                          None if m is None else torch.tensor(m, device=cuda),
                          normalize)
    torch.cuda.synchronize()
    assert DC.conv3d_dense.launches == n0 + (2 if normalize else 1)
    want = F2.dense_conv2d(torch.tensor(x), k,
                           None if m is None else torch.tensor(m), normalize)
    _close_blur(got.cpu(), want)


@pytest.mark.parametrize("hz", [1, 4, 13])
@pytest.mark.parametrize("shape", [(30, 18, 40), (5, 33, 70)])
def test_conv1d_axis_z_pass_matches_twin(cuda, hz, shape):
    """ops/conv.conv1d_axis on the card (blur3 with 1-tap kernels on y
    and x: one launch) against the plain z pass on the CPU, an asymmetric
    kernel; over a (2, 2) mesh on the card bit for bit the one-device
    result."""
    from visfd_tpu_torch.ops import blur_cuda
    rng = _rng(82)
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.uniform(0.1, 1.0, 2 * hz + 1).astype(np.float32)
    n0 = blur_cuda.blur3.launches
    got = conv.conv1d_axis(torch.tensor(x, device=cuda), k, 0)
    torch.cuda.synchronize()
    assert blur_cuda.blur3.launches == n0 + 1
    want = blur_cuda.conv1d_axis(torch.tensor(x), torch.tensor(k), 0)
    _close_blur(got.cpu(), want)
    if shape[0] % 2 == 0 and shape[1] % 2 == 0:
        mesh = make_mesh(4, devices=[cuda] * 4)
        sh = conv.conv1d_axis(shard(x, mesh), k, 0)
        assert np.array_equal(to_host_np(sh), got.cpu().numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_distance_to_points_card_equals_cpu(cuda, masked):
    """The distance map on the card bit for bit the CPU's (int32 squared
    distances, a float64 square root rounded to float32)."""
    from visfd_tpu_torch.features import experimental as EX
    rng = _rng(83)
    shape = (17, 40, 4200)
    pts = np.stack([rng.integers(-5, 4205, 40), rng.integers(0, 40, 40),
                    rng.integers(0, 17, 40)], -1)
    x = rng.normal(size=shape).astype(np.float32)
    kw = dict(mask=(x > 0).astype(np.float32), background=x) if masked \
        else {}
    got = EX.distance_to_points(shape, pts, 0.731, device=cuda, **kw)
    want = EX.distance_to_points(shape, pts, 0.731, device="cpu", **kw)
    assert np.array_equal(got.cpu().numpy(), want.numpy())
    d = EX.distance_points_to_feature(x, pts, 3.0, 4.0, 0.731,
                                      mask=kw.get("mask"), device=cuda)
    dw = EX.distance_points_to_feature(x, pts, 3.0, 4.0, 0.731,
                                       mask=kw.get("mask"), device="cpu")
    assert np.array_equal(d, dw)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fn", ["template", "doggxy"])
def test_experimental_filters_card_match_cpu(cuda, masked, fn):
    """-template-gauss's and -doggxy's functions on the card against the
    CPU (kernels of at most 7^3 taps): the template amplitude to an
    absolute 2^-20 max|x| sum|w Q_| (its kernel has zero mean), -doggxy
    rtol 1e-5 / atol 1e-6 of the largest."""
    from visfd_tpu_torch.features import experimental as EX
    rng = _rng(84)
    x = rng.normal(size=(14, 33, 45)).astype(np.float32)
    m = (rng.uniform(size=x.shape) > 0.3).astype(np.float32) if masked \
        else None
    outs = []
    for dev in (cuda, "cpu"):
        xd = torch.tensor(x, device=dev)
        md = None if m is None else torch.tensor(m, device=dev)
        if fn == "template":
            outs.append(EX.template_gen_gauss(xd, (1.5,) * 3, (2.0,) * 3,
                                              mask=md, truncate_ratio=1.5))
        else:
            outs.append(EX.dogg_xy(xd, (1.0, 1.0), (2.0, 2.0), 1.5, mask=md))
    got, want = outs[0].cpu().numpy(), outs[1].numpy()
    if fn == "doggxy":
        _close_blur(got, want)
        return
    w = K.gen_gauss_kernel_3d((2.0,) * 3, 2.0, (3,) * 3, normalize=False)
    q = K.gen_gauss_kernel_3d((1.5,) * 3, 2.0, (3,) * 3, normalize=False)
    q_ = q - float((w * q).sum() / w.sum())
    q_ = q_ / np.sqrt((w * q_ * q_).sum())
    atol = 2.0 ** -20 * float(np.abs(x).max()) * float(np.abs(w * q_).sum())
    assert float(np.abs(got - want).max()) <= atol


def test_device_tools_card_match_cpu(cuda, tmp_path, capsys):
    """combine_mrc (bytes), sum_voxels (the printed line) and pval_mrc
    (the extreme's voxel; numbers rtol 1e-5) on the card against the
    CPU."""
    from visfd_tpu_torch.cli import combine_mrc, pval_mrc, sum_voxels
    rng = _rng(85)
    a = rng.normal(size=(20, 24, 28)).astype(np.float32)
    m = (rng.uniform(size=a.shape) > 0.3).astype(np.float32)
    pts = np.zeros(a.shape, np.float32)
    pts[8:11, 8:11, 8:11] = 1.0
    for name, v in (("a", a), ("m", m), ("p", pts)):
        mrc.write_mrc(str(tmp_path / f"{name}.mrc"), v)
    outs = {}
    for dev in (cuda, "cpu"):
        tag = str(dev)[:4]
        assert combine_mrc.run(["-mask", f"{tmp_path}/m.mrc",
                                f"{tmp_path}/a.mrc,-0.5,0.5", "*",
                                f"{tmp_path}/a.mrc",
                                f"{tmp_path}/c_{tag}.mrc"], device=dev) == 0
        capsys.readouterr()
        assert sum_voxels.run(["-mask", f"{tmp_path}/m.mrc", "-thresh2",
                               "-0.5", "0.5", "-stddev", f"{tmp_path}/a.mrc"],
                              device=dev) == 0
        assert pval_mrc.run(["-in", f"{tmp_path}/p.mrc", "-gauss-sweep", "1",
                             "3", "1.5", "-max"], device=dev) == 0
        outs[tag] = capsys.readouterr().out.splitlines()
    assert (tmp_path / "c_cuda.mrc").read_bytes() == \
        (tmp_path / "c_cpu.mrc").read_bytes()
    card, cpu = outs["cuda"], outs["cpu"]
    assert card[0] == cpu[0]
    for rc, rw in zip(card[1:], cpu[1:]):
        rc, rw = rc.split(), rw.split()
        assert rc[2:5] == rw[2:5]
        np.testing.assert_allclose([float(v) for v in rc[:2] + rc[5:]],
                                   [float(v) for v in rw[:2] + rw[5:]],
                                   rtol=1e-5)
