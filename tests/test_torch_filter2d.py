"""The port's ``ops/filter2d`` against the JAX package's, on the CPU:
the kernel constructors bit for bit (float64 host math), the filters
to rtol 1e-5 and atol 1e-6 of the largest magnitude (float32 sums of
the taps in another order; the DoGG's lobes cancel to near zero)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visfd_tpu.ops import filter2d as J2
from visfd_tpu_torch.ops import filter2d as T2
from visfd_tpu_torch.parallel.mesh import make_mesh, shard

SHAPE = (5, 19, 23)


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


def _close(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("width,m,hw,normalize", [
    ((2.0, 2.0), 2.0, (5, 5), True), ((1.5, 3.0), 1.3, (3, 7), True),
    ((0.0, 2.0), 2.0, (2, 4), True), ((2.5, 1.0), 3.0, (6, 2), False)])
def test_gen_gauss_kernel_2d_bit_identical(width, m, hw, normalize):
    np.testing.assert_array_equal(
        T2.gen_gauss_kernel_2d(width, m, hw, normalize),
        J2.gen_gauss_kernel_2d(width, m, hw, normalize))


@pytest.mark.parametrize("sigma,hw", [((1.0, 1.0), (3, 3)),
                                      ((0.7, 2.2), (2, 6))])
def test_gauss_kernel_2d_bit_identical(sigma, hw):
    np.testing.assert_array_equal(T2.gauss_kernel_2d(sigma, hw),
                                  J2.gauss_kernel_2d(sigma, hw))


@pytest.mark.parametrize("a,b,m,n,ratio", [
    ((1.0, 1.0), (2.0, 2.0), 2.0, 2.0, -1.0),
    ((1.2, 0.8), (2.5, 1.7), 1.5, 2.5, -1.0),
    ((1.0, 1.5), (2.0, 3.0), 2.0, 2.0, 2.0)])
def test_dogg_kernel_2d_bit_identical(a, b, m, n, ratio):
    kt, abt = T2.dogg_kernel_2d(a, b, m, n, ratio)
    kj, abj = J2.dogg_kernel_2d(a, b, m, n, ratio)
    np.testing.assert_array_equal(kt, kj)
    assert abt == abj


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("two_d", [False, True])
def test_dense_conv2d_close(masked, normalize, two_d):
    x, mask = _volume(1)
    k = np.random.default_rng(2).normal(size=(5, 7)).astype(np.float32)
    if normalize:
        k = np.abs(k)  # a denominator of positive weights
    if two_d:
        x, mask = x[2], mask[2]
    m = mask if masked else None
    want = J2.dense_conv2d(jnp.asarray(x), k,
                           None if m is None else jnp.asarray(m), normalize)
    got = T2.dense_conv2d(torch.tensor(x), k,
                          None if m is None else torch.tensor(m), normalize)
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("width,m_exp", [((1.5, 1.5), 2.0),
                                         ((1.0, 2.0), 1.5)])
def test_apply_gen_gauss_2d_close(masked, normalize, width, m_exp):
    x, mask = _volume(3)
    m = mask if masked else None
    want = J2.apply_gen_gauss_2d(jnp.asarray(x), width, m_exp,
                                 None if m is None else jnp.asarray(m),
                                 normalize=normalize)
    got = T2.apply_gen_gauss_2d(torch.tensor(x), width, m_exp,
                                None if m is None else torch.tensor(m),
                                normalize=normalize)
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("a,b,m,n", [((1.0, 1.0), (2.0, 2.0), 2.0, 2.0),
                                     ((1.2, 0.8), (2.5, 1.7), 1.5, 2.5)])
def test_apply_dogg_2d_close(masked, a, b, m, n):
    x, mask = _volume(4)
    mk = mask if masked else None
    want = J2.apply_dogg_2d(jnp.asarray(x), a, b, m, n,
                            None if mk is None else jnp.asarray(mk))
    got = T2.apply_dogg_2d(torch.tensor(x), a, b, m, n,
                           None if mk is None else torch.tensor(mk))
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_apply_dogg_2d_sharded_equals_one_device(masked):
    """On a (4, 2) grid of CPU blocks (y halos only), bit for bit the
    one-device result."""
    x, mask = _volume(5, (8, 18, 23))
    mesh = make_mesh(8, devices=["cpu"] * 8)
    m = mask if masked else None
    want = T2.apply_dogg_2d(torch.tensor(x), (1.0, 1.0), (2.0, 2.0), 2.0, 2.0,
                            None if m is None else torch.tensor(m)).numpy()
    got = T2.apply_dogg_2d(shard(x, mesh), (1.0, 1.0), (2.0, 2.0), 2.0, 2.0,
                           None if m is None else shard(m, mesh))
    bz, by = got.block_shape
    for iz, iy, b in got.cells():
        np.testing.assert_array_equal(
            b.numpy(), want[iz * bz:(iz + 1) * bz, iy * by:(iy + 1) * by])
