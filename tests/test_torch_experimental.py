"""The port's ``features/experimental`` against the JAX package's, on the
CPU, on seeded numpy inputs, masked and unmasked.

Tolerances:

* ``distance_to_points``, ``distance_points_to_feature``,
  ``random_spheres`` and ``blob_radial_intensity``: equal bit for bit
  (integer squared distances and one correctly rounded square root; the
  host functions are the JAX package's numpy code).
* ``template_gen_gauss``: absolute, 2^-20 * max|x| * sum|w Q_| (the
  amplitude kernel w Q_ has zero mean and p = x - background cancels,
  so a relative tolerance means nothing near zero; the bound is a few
  float32 roundings of the inputs carried through the kernel's
  absolute sum).
* ``dogg_xy``: rtol 1e-5, atol 1e-6 of the largest magnitude (float32
  sums in another order; the difference of two Gaussians cancels).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visfd_tpu.features import experimental as JE
from visfd_tpu.ops import kernels as JK
from visfd_tpu_torch.features import experimental as TE
from visfd_tpu_torch.parallel.mesh import make_mesh, shard

SHAPE = (12, 17, 21)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _volume(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    mask = (rng.uniform(size=shape) > 0.3).astype(np.float32)
    return x, mask


def _points(seed, n, shape=SHAPE):
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    # a few points outside the volume, as a coordinate file may give
    return np.stack([rng.integers(-3, nx + 3, n), rng.integers(-3, ny + 3, n),
                     rng.integers(-3, nz + 3, n)], -1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_points,vw", [(0, 1.0), (1, 2.5), (37, 0.731)])
def test_distance_to_points_bit_identical(masked, n_points, vw):
    x, mask = _volume(1)
    pts = _points(2, n_points)
    kw = dict(mask=mask, background=x) if masked else {}
    want = JE.distance_to_points(SHAPE, pts, vw, **kw)
    got = TE.distance_to_points(SHAPE, pts, vw, device="cpu", **kw).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_distance_to_points_rounds_above_2_24():
    """Squared distances above 2^24 are rounded to float32 before the
    square root, as in the JAX package."""
    shape = (3, 4, 4200)
    pts = np.array([[0, 0, 0]])
    want = JE.distance_to_points(shape, pts, 1.0)
    got = TE.distance_to_points(shape, pts, 1.0, device="cpu").numpy()
    assert (np.arange(4200) ** 2 > 2 ** 24).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lo,hi", [(0.5, 1.5), (9.0, 10.0)])
def test_distance_points_to_feature_equal(masked, lo, hi, monkeypatch):
    x, mask = _volume(3)
    pts = _points(4, 23)
    m = mask if masked else None
    # blocks of a few points, so the chunking is exercised
    monkeypatch.setattr(TE, "PAIR_ELEMENTS", 5000)
    want = JE.distance_points_to_feature(x, pts, lo, hi, 1.7, mask=m)
    got = TE.distance_points_to_feature(x, pts, lo, hi, 1.7, mask=m,
                                        device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if lo > 5:
        assert np.isinf(got).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,diam,seed", [(6, 4.0, 0), (3, 5.0, 7)])
def test_random_spheres_equal(masked, n, diam, seed):
    """Spheres packed into the low band (z < 14) of a noisy two-level
    volume, and into the mask's slab (x < 22)."""
    x, _ = _volume(5, (20, 24, 28))
    x = 0.1 * x + np.where(np.arange(20) < 14, 0.0, 5.0)[:, None, None]
    mask = np.zeros_like(x)
    mask[:, :, :22] = 1.0
    m = mask if masked else None
    cw, ow = JE.random_spheres(x, n, diam, -1.0, 1.0, seed=seed, mask=m)
    cg, og = TE.random_spheres(x, n, diam, -1.0, 1.0, seed=seed, mask=m)
    assert len(cg) == n
    np.testing.assert_array_equal(cg, cw)
    np.testing.assert_array_equal(og, ow)


def test_random_spheres_too_small():
    x, _ = _volume(5, (6, 20, 20))
    with pytest.raises(ValueError, match="smaller than the spheres"):
        TE.random_spheres(x, 1, 8.0, -1, 1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("criteria", ["min", "max", "center"])
@pytest.mark.parametrize("center,diam,width", [((9.4, 8.6, 5.2), 6.0, -1.0),
                                               ((1.0, 16.2, 11.0), 4.5, 9.0)])
def test_blob_radial_intensity_equal(masked, criteria, center, diam, width):
    x, mask = _volume(6)
    m = mask if masked else None
    pw, cw = JE.blob_radial_intensity(x, center, diam, criteria, mask=m,
                                      radius_profile_width=width)
    pg, cg = TE.blob_radial_intensity(x, center, diam, criteria, mask=m,
                                      radius_profile_width=width)
    assert cg == cw
    np.testing.assert_array_equal(pg, pw)


def _template_atol(x, wa, wr, m_exp, n_exp, ratio):
    """2^-20 max|x| sum|w Q_| for the template's amplitude kernel."""
    hws = tuple(max(1, int(np.floor(r * ratio))) for r in wr)
    w = JK.gen_gauss_kernel_3d(wr, n_exp, hws, normalize=False)
    q = JK.gen_gauss_kernel_3d(wa, m_exp, hws, normalize=False)
    q_ = q - float((w * q).sum() / w.sum())
    q_ = q_ / np.sqrt((w * q_ * q_).sum())
    return 2.0 ** -20 * float(np.abs(x).max()) * float(np.abs(w * q_).sum())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("wa,wr,m_exp,n_exp,normalize", [
    ((1.5, 1.5, 1.5), (3.0, 3.0, 3.0), 2.0, 2.0, True),
    ((1.2, 1.8, 1.0), (2.5, 3.0, 2.0), 2.0, 2.0, False),
    ((1.5, 1.5, 1.5), (2.4, 2.4, 2.4), 1.5, 3.0, True),
])
def test_template_gen_gauss_close(masked, wa, wr, m_exp, n_exp, normalize):
    x, mask = _volume(8)
    m = mask if masked else None
    kw = dict(m_exp=m_exp, n_exp=n_exp, truncate_ratio=1.5,
              normalize_near_boundaries=normalize)
    want = np.asarray(JE.template_gen_gauss(
        jnp.asarray(x), wa, wr, mask=None if m is None else jnp.asarray(m),
        **kw))
    got = TE.template_gen_gauss(torch.tensor(x), wa, wr,
                                mask=None if m is None else torch.tensor(m),
                                **kw).numpy()
    atol = _template_atol(x, wa, wr, m_exp, n_exp, 1.5)
    err = float(np.abs(got - want).max())
    print(f"template_gen_gauss max|d| {err:.3g} (atol {atol:.3g})")
    assert err <= atol


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("a,b,sz,m_exp,n_exp", [
    ((1.0, 1.0), (2.0, 2.0), 1.5, 2.0, 2.0),
    ((1.2, 0.8), (2.4, 1.6), 0.7, 1.5, 2.5),
])
def test_dogg_xy_close(masked, a, b, sz, m_exp, n_exp):
    x, mask = _volume(9)
    m = mask if masked else None
    want = np.asarray(JE.dogg_xy(
        jnp.asarray(x), a, b, sz, m_exp=m_exp, n_exp=n_exp,
        mask=None if m is None else jnp.asarray(m)))
    got = TE.dogg_xy(torch.tensor(x), a, b, sz, m_exp=m_exp, n_exp=n_exp,
                     mask=None if m is None else torch.tensor(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("fn", ["template", "doggxy"])
def test_sharded_equals_one_device(fn):
    """On a (4, 2) grid of CPU blocks, each filter equals the one-device
    result bit for bit (the blocks read halos as deep as the kernels)."""
    x, mask = _volume(10, (16, 20, 21))
    mesh = make_mesh(8, devices=["cpu"] * 8)
    xs, ms = shard(x, mesh), shard(mask, mesh)
    xt, mt = torch.tensor(x), torch.tensor(mask)
    if fn == "template":
        def run(v, m):
            return TE.template_gen_gauss(v, (1.5,) * 3, (2.5,) * 3, mask=m,
                                         truncate_ratio=1.5)
    else:
        def run(v, m):
            return TE.dogg_xy(v, (1.0, 1.0), (2.0, 2.0), 1.2, mask=m)
    want = run(xt, mt).numpy()
    got = run(xs, ms)
    bz, by = got.block_shape
    whole = np.empty_like(want)
    for iz, iy, b in got.cells():
        whole[iz * bz:(iz + 1) * bz, iy * by:(iy + 1) * by] = b.numpy()
    np.testing.assert_array_equal(whole, want)
