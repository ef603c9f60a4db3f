"""The PyTorch port's separable blur (ops/conv, ops/filters,
ops/blur_cuda) and binning (ops/resample) against the JAX package.

One seeded numpy input goes through both packages.  The JAX blur kernel
runs in interpret mode (as the JAX package's tests run it on a CPU);
here the port takes the kernel's plain twin (the CUDA kernel is held
against that twin on a card in tests/test_torch_cuda_kernels.py).
Tolerance: rtol 1e-5, atol 1e-6 of
the largest magnitude (float32 sums of up to 3 x 61 taps taken in
another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visfd_tpu.ops import conv as jconv
from visfd_tpu.ops import filters as jfilters
from visfd_tpu.ops import resample as jresample
from visfd_tpu.ops.blur_pallas import blur3_pallas
from visfd_tpu_torch.convert import to_numpy, to_torch
from visfd_tpu_torch.ops import blur_cuda, conv, filters, resample
from visfd_tpu_torch.ops.blur_cuda import blur3

SHAPE = (12, 20, 33)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=SHAPE).astype(np.float32)
    mask = (rng.uniform(size=SHAPE) > 0.3).astype(np.float32)
    return x, mask


# an asymmetric kernel set: a flipped (correlation instead of
# convolution) blur would pass every check with a Gaussian
ASYM = (np.array([0.1, 0.5, 0.25, 0.1, 0.05], np.float32),
        np.array([0.6, 0.3, 0.1], np.float32),
        np.array([0.05, 0.1, 0.15, 0.2, 0.3, 0.15, 0.05], np.float32))


def _gauss(sigma, hw):
    from visfd_tpu_torch.ops import kernels as K
    return tuple(K.gauss_kernel_1d(sigma, hw) for _ in range(3))


@pytest.mark.parametrize("kernels", ["asym", "gauss"])
def test_blur3_twin_matches_jax_kernel(kernels):
    x, _ = _inputs()
    ks = ASYM if kernels == "asym" else _gauss(1.7, 4)
    want = blur3_pallas(jnp.asarray(x), ks, interpret=True)
    got = blur3(to_torch(x), ks)
    _close(to_numpy(got), want)


@pytest.mark.parametrize("form", ["nomask", "masked", "raw", "raw_masked"])
@pytest.mark.parametrize("kernels", ["asym", "gauss"])
def test_separable_conv3d_matches_jax(form, kernels):
    x, mask = _inputs(1)
    ks = ASYM if kernels == "asym" else _gauss(2.2, 5)
    use_mask = form in ("masked", "raw_masked")
    normalize = form in ("nomask", "masked")
    want = jconv.separable_conv3d(
        jnp.asarray(x), ks, mask=jnp.asarray(mask) if use_mask else None,
        normalize=normalize)
    got = conv.separable_conv3d(
        to_torch(x), ks, mask=to_torch(mask) if use_mask else None,
        normalize=normalize)
    _close(to_numpy(got), want)


@pytest.mark.parametrize("masked", [False, True])
def test_apply_gauss_matches_jax(masked):
    x, mask = _inputs(2)
    kw = dict(truncate_halfwidth=(3, 4, 2))
    want = jfilters.apply_gauss(
        jnp.asarray(x), (1.2, 1.6, 0.9),
        mask=jnp.asarray(mask) if masked else None, **kw)
    got = filters.apply_gauss(
        to_torch(x), (1.2, 1.6, 0.9),
        mask=to_torch(mask) if masked else None, **kw)
    _close(to_numpy(got), want)


def test_bin_unbin_match_jax():
    x, _ = _inputs(3)
    dest = (6, 10, 16)
    want = jresample.bin_array3d(jnp.asarray(x), dest)
    got = resample.bin_array3d(to_torch(x), dest)
    _close(to_numpy(got), want)
    want_u = jresample.unbin_array3d(want, SHAPE)
    got_u = resample.unbin_array3d(got, SHAPE)
    assert got_u.shape == SHAPE
    _close(to_numpy(got_u), want_u)


def test_blur_smem_plan_fits_up_to_the_cap():
    """The fused blur's shared-memory plan fits a Hopper block for every
    halfwidth it accepts, on every axis alike and for uneven ones, and
    the cap is where no tile fits any more."""
    cap = blur_cuda.MAX_KERNEL_HALFWIDTH
    for h in range(cap + 1):
        for hs in ((h, h, h), (h, 0, h), (0, h, 1)):
            rows, nbytes = blur_cuda.smem_plan(*hs)
            assert rows in ((8,) if hs[0] == hs[1] == hs[2] and
                            1 <= h <= 8 else (8, 4, 2, 1))
            assert nbytes <= 232448
    assert blur_cuda.smem_plan(cap + 1, cap + 1, cap + 1) is None
    assert blur_cuda.smem_plan(4, 4, 4) == (8, 4 * (3 * 40 * 40 + 2 * 32 * 40))


@pytest.mark.parametrize("h", range(1, 13))
def test_blur_instance_for_each_halfwidth(h):
    """One halfwidth on every axis takes the wide instance at 6-10, a
    compiled one at 1-5, the runtime one past 10; uneven widths take the
    runtime one; every plan fits a Hopper block."""
    want = ("compiled" if h <= 5 else "wide" if h <= 10 else "runtime")
    assert blur_cuda.instance(h, h, h) == want
    uneven = ((h, h, h - 1), (h - 1, h, h), (h, h + 1, h), (h, 0, h),
              (0, h, 1))
    for hs in uneven:
        assert blur_cuda.instance(*hs) == "runtime"
    for hs in ((h, h, h),) + uneven:
        rows, nbytes = blur_cuda.smem_plan(*hs)
        assert rows in (8, 4, 2, 1) and nbytes <= blur_cuda.SMEM_LIMIT
    if want == "wide":
        # four staged (32 + 2h)-row planes, rows of 32 + 2a + 4 floats (a:
        # h rounded up to 4), two planes of x-blurred rows 36 apart, the
        # three axes' taps in float4s
        a = 8 if h <= 8 else 12
        wp = {6: 16, 7: 16, 8: 20, 9: 20, 10: 24}[h]
        ry = 32 + 2 * h
        assert blur_cuda.smem_plan(h, h, h) == (
            8, 4 * (4 * ry * (36 + 2 * a) + 2 * ry * 36 + 3 * wp))


def test_blur_plan_of_the_other_widths_is_unchanged():
    """The wide instance moves neither the compiled instances' plan nor
    the largest halfwidth a fused tile holds, nor the per-axis mode
    past it."""
    assert blur_cuda.smem_plan(4, 4, 4) == (8, 4 * (3 * 40 * 40 + 2 * 32 * 40))
    assert blur_cuda.MAX_KERNEL_HALFWIDTH == 54
    assert blur_cuda.instance(54, 54, 54) == "runtime"
    assert blur_cuda.instance(55, 55, 55) == "axis"
    assert blur_cuda.smem_plan(55, 55, 55) is None


@pytest.mark.parametrize("shape,h,n_sm,want", [
    ((256, 1024, 1024), 10, 132, 256),   # 4 waves of the whole depth
    ((256, 1024, 1024), 9, 132, 256),
    ((512, 64, 64), 10, 132, 8),         # 4 tiles x 64 chunks, one wave
    ((128, 512, 512), 10, 132, 128),     # one wave
    ((64, 64, 64), 10, 132, 1),          # 4 tiles: 256 blocks, one wave
    ((1, 40, 40), 9, 132, 1),
])
def test_wide_chunk_balances_waves_and_halo_planes(shape, h, n_sm, want):
    tz = blur_cuda.wide_chunk(shape, h, n_sm)
    assert tz == want and 1 <= tz <= shape[0]
