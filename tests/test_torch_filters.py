"""The port's filters (ops/filters, ops/conv.dense_conv3d, ops/morphology)
against the JAX package, and over (z, y) blocks against one device.

One seeded numpy volume of 20 x 28 x 40 (sides that differ) goes
through both packages; the port runs its plain twins on the CPU (the
CUDA kernels are held against those twins on a card in
tests/test_torch_cuda_kernels.py).  Tolerances:

* separable filters (Gaussian, DoG, LoG, fluctuations with m = 2):
  rtol 1e-5, atol 1e-6 of the largest magnitude (float32 sums of up to
  3 x 2hw+1 taps taken in another order);
* the LoG: rtol 1e-5, atol 1e-6 of the largest input magnitude times
  1 / delta^2 (its two Gaussians' float32 roundings, amplified by the
  1 / delta^2 that scales their difference);
* dense convolutions (generalized Gaussians, DoGG, fluctuations with
  m != 2): rtol 1e-5, atol 1e-6 of the largest magnitude (a float32 sum
  of up to 11^3 products in the kernel's order against XLA's
  convolution at HIGHEST precision; the DoGG's two lobes cancel to
  near zero, where only the absolute term holds);
* median, morphology, footprints: exact (selections and comparisons);
* every blockwise (-mesh) result: bit for bit the single-device one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visfd_tpu.ops import conv as jconv
from visfd_tpu.ops import filters as jfilters
from visfd_tpu.ops import morphology as jmorph
from visfd_tpu_torch.ops import conv, filters, morphology
from visfd_tpu_torch.ops.dense_cuda import conv3d_dense
from visfd_tpu_torch.parallel.gather import to_host_np
from visfd_tpu_torch.parallel.mesh import make_mesh, shard

SHAPE = (20, 28, 40)
LOG_DELTA = 0.05


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=SHAPE).astype(np.float32)
    mask = (rng.uniform(size=SHAPE) > 0.25).astype(np.float32)
    return x, mask


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _t(a):
    return None if a is None else torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _blocks(a, n):
    return None if a is None else shard(a, make_mesh(devices=["cpu"] * n))


# --- separable filters -----------------------------------------------------

SEPARABLE = {
    "gauss-aniso": lambda F, x, m, nrm: F.apply_gauss(
        x, (1.3, 2.1, 0.8), m, normalize=nrm),
    "gauss-halfwidth": lambda F, x, m, nrm: F.apply_gauss(
        x, 1.7, m, truncate_halfwidth=(3, 5, 2), normalize=nrm),
    "dog": lambda F, x, m, nrm: F.apply_dog(
        x, (1.2, 1.5, 1.0), (2.0, 2.4, 1.7), m, normalize=nrm),
    "log": lambda F, x, m, nrm: F.apply_log(
        x, (1.6, 1.9, 1.4), m, delta_sigma_over_sigma=LOG_DELTA),
    "fluct": lambda F, x, m, nrm: F.local_fluctuations(
        x, (1.5, 1.2, 1.8), m, normalize=nrm),
    "fluct-radius": lambda F, x, m, nrm: F.local_fluctuations_by_radius(
        x, 2.5, m, truncate_ratio=2.0, normalize=nrm),
}


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(SEPARABLE))
def test_separable_filters_match_jax(name, masked, normalize):
    x, mask = _inputs(1)
    m = mask if masked else None
    f = SEPARABLE[name]
    want = np.asarray(f(jfilters, jnp.asarray(x), _j(m), normalize))
    got = f(filters, _t(x), _t(m), normalize).numpy()
    if name == "log":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(
            x).max() / LOG_DELTA ** 2)
    else:
        _close(got, want)


# --- dense convolutions ----------------------------------------------------

DENSE = {
    "ggauss": lambda F, x, m, nrm: F.apply_gen_gauss(
        x, (1.5, 2.0, 1.2), 3.0, m, truncate_ratio=1.8, normalize=nrm),
    "ggauss-m2": lambda F, x, m, nrm: F.apply_gen_gauss(
        x, 2.0, 2.0, m, truncate_halfwidth=(2, 3, 4), normalize=nrm),
    "dogg": lambda F, x, m, nrm: F.apply_dogg(
        x, (1.2, 1.2, 1.0), (2.2, 2.5, 2.0), 2.0, 4.0, m),
    "dogg-ratio": lambda F, x, m, nrm: F.apply_dogg(
        x, 1.0, 1.8, 1.5, 3.0, m, truncate_ratio=2.0),
    "fluct-m4": lambda F, x, m, nrm: F.local_fluctuations(
        x, (1.4, 1.1, 1.6), m, m_exp=4.0, truncate_ratio=2.0,
        normalize=nrm),
}


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(DENSE))
def test_dense_filters_match_jax(name, masked, normalize):
    x, mask = _inputs(2)
    m = mask if masked else None
    f = DENSE[name]
    want = np.asarray(f(jfilters, jnp.asarray(x), _j(m), normalize))
    got = f(filters, _t(x), _t(m), normalize).numpy()
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_dense_conv3d_asymmetric_kernel_matches_jax(masked):
    """An asymmetric kernel (a correlation instead of a convolution would
    fail), with and without the mask's normalisation."""
    x, mask = _inputs(3)
    rng = np.random.default_rng(4)
    k = rng.uniform(0.0, 1.0, size=(3, 5, 7)).astype(np.float32)
    m = mask if masked else None
    for nrm in (True, False):
        want = np.asarray(jconv.dense_conv3d(jnp.asarray(x), k, _j(m), nrm))
        got = conv.dense_conv3d(_t(x), k, _t(m), nrm).numpy()
        _close(got, want)


def test_conv3d_dense_twin_propagates_nan_like_xla():
    """A NaN sample spreads over the kernel's reach, zero taps included,
    as in XLA's convolution."""
    x, _ = _inputs(5)
    x[7, 9, 11] = np.nan
    k = np.zeros((3, 3, 3), np.float32)
    k[1, 1, 1] = 1.0
    want = np.asarray(jconv.dense_conv3d(jnp.asarray(x), k, None, False))
    got = conv.dense_conv3d(_t(x), k, None, False).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).sum() == 27
    _close(got[np.isfinite(got)], want[np.isfinite(want)])


# --- median -----------------------------------------------------------------

@pytest.mark.parametrize("radius", [1, 2, (1.5, 2.0, 1.0), 0.5])
@pytest.mark.parametrize("masked", [False, True])
def test_median_matches_jax(radius, masked):
    x, mask = _inputs(6)
    x[3, 4, 5] = np.nan
    m = mask if masked else None
    want = np.asarray(jfilters.median_filter(jnp.asarray(x), radius, _j(m)))
    got = filters.median_filter(_t(x), radius, _t(m)).numpy()
    np.testing.assert_array_equal(got, want)


def test_median_slabs_equal_one_pass(monkeypatch):
    """The median in slabs of one plane equals it in one slab."""
    x, mask = _inputs(7)
    whole = filters.median_filter(_t(x), 2, _t(mask)).numpy()
    k = len(filters.sphere_footprint_offsets(2))
    monkeypatch.setattr(filters, "MEDIAN_STACK_ELEMENTS", k * 40)
    np.testing.assert_array_equal(
        filters.median_filter(_t(x), 2, _t(mask)).numpy(), whole)


@pytest.mark.parametrize("radius", [1, 2.5, (2.0, 1.0, 0.0)])
def test_sphere_footprint_offsets_match_jax(radius):
    np.testing.assert_array_equal(filters.sphere_footprint_offsets(radius),
                                  jfilters.sphere_footprint_offsets(radius))


@pytest.mark.parametrize("d", [(0, 0, 1), (-2, 1, 0), (1, -3, 2)])
def test_shift3_matches_jax(d):
    x, _ = _inputs(8)
    np.testing.assert_array_equal(
        filters._shift3(_t(x), d, fill=-7.0).numpy(),
        np.asarray(jfilters._shift3(jnp.asarray(x), d, fill=-7.0)))


# --- morphology -------------------------------------------------------------

MORPH = ["dilate_sphere", "erode_sphere", "open_sphere", "close_sphere",
         "white_top_hat_sphere", "black_top_hat_sphere"]
SE = {"flat": (2.0, 0.0, 0.0), "soft-shell": (1.5, 2.5, 3.0),
      "anti-aliased": (1.7, 0.0, 2.0)}


@pytest.mark.parametrize("se", list(SE))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("op", MORPH)
def test_morphology_matches_jax(op, masked, se):
    x, mask = _inputs(9)
    x[10, 2, 30] = np.nan
    m = mask if masked else None
    r, rmax, bmax = SE[se]
    want = np.asarray(getattr(jmorph, op)(jnp.asarray(x), r, _j(m), rmax,
                                          bmax))
    got = getattr(morphology, op)(_t(x), r, _t(m), rmax, bmax).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("se", list(SE))
def test_sphere_structure_element_matches_jax(se):
    for a, b in zip(morphology.sphere_structure_element(*SE[se]),
                    jmorph.sphere_structure_element(*SE[se])):
        np.testing.assert_array_equal(a, b)


# --- the blocks of a -mesh run: bit for bit one device ---------------------

BLOCKWISE = {
    "gauss": lambda x, m: filters.apply_gauss(x, (1.3, 2.1, 0.8), m),
    "dog": lambda x, m: filters.apply_dog(x, 1.2, 2.0, m),
    "log": lambda x, m: filters.apply_log(x, 1.7, m),
    "fluct": lambda x, m: filters.local_fluctuations(x, 1.5, m),
    "ggauss": lambda x, m: filters.apply_gen_gauss(
        x, (1.5, 2.0, 1.2), 3.0, m, truncate_ratio=1.8),
    "dogg": lambda x, m: filters.apply_dogg(x, 1.2, 2.2, 2.0, 4.0, m),
    "fluct-m4": lambda x, m: filters.local_fluctuations(
        x, 1.4, m, m_exp=4.0, truncate_ratio=2.0),
    "median": lambda x, m: filters.median_filter(x, 2, m),
    "open": lambda x, m: morphology.open_sphere(x, 2.0, m),
    "black-top-hat": lambda x, m: morphology.black_top_hat_sphere(
        x, 1.5, m, 2.5, 3.0),
}


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(BLOCKWISE))
def test_blockwise_filters_equal_one_device(name, masked, n):
    """On (2, 2) and (4, 2) CPU blocks (5-plane blocks under halos up to
    6 deep), each filter gives the single-device bits."""
    x, mask = _inputs(10)
    m = mask if masked else None
    one = BLOCKWISE[name](_t(x), _t(m)).numpy()
    got = to_host_np(BLOCKWISE[name](_blocks(x, n), _blocks(m, n)))
    np.testing.assert_array_equal(got, one)


def test_conv3d_dense_twin_on_a_haloed_block_equals_whole():
    """The dense twin's interior of a haloed block equals the whole
    volume's bits (what the blockwise dense filters rest on)."""
    x, _ = _inputs(11)
    k = np.random.default_rng(12).normal(size=(5, 3, 7)).astype(np.float32)
    whole = conv3d_dense(_t(x), torch.tensor(k)).numpy()
    sub = np.zeros((8 + 4, 10 + 2, 40), np.float32)
    sub[:, :, :] = x[4 - 2:12 + 2, 6 - 1:16 + 1]
    blk = conv3d_dense(_t(sub), torch.tensor(k)).numpy()[2:10, 1:11]
    np.testing.assert_array_equal(blk, whole[4:12, 6:16])
