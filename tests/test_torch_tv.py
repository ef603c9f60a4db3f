"""The PyTorch port's stick tensor voting (ops/tv_cuda, features/tv)
against the JAX package: its Pallas voting kernel in interpret mode and
its XLA tv_dense_stick.

On the CPU the port takes the kernel's plain twin (the CUDA kernel is
held against that twin on a card, dense and sparse, in
tests/test_torch_cuda_kernels.py).  Tolerance: rtol 2e-4, atol 2e-5
(tests/test_tv_pallas.py: up to 343 float32 vote terms summed in
another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visfd_tpu.features import tv as JTV
from visfd_tpu.ops import kernels as JK
from visfd_tpu.ops.tv_pallas import tv_dense_stick_pallas
from visfd_tpu_torch.convert import to_numpy, to_torch
from visfd_tpu_torch.features import tv as TTV
from visfd_tpu_torch.ops import tv_cuda as TC
from visfd_tpu_torch.ops.tv_cuda import tv_votes

SHAPE = (12, 20, 36)
RATIO = float(np.sqrt(2.0))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _sigma(hw):
    return hw / RATIO + 1e-6  # floor(sigma * sqrt(2)) == hw


def _fields(seed, occupancy=0.6, shape=SHAPE):
    rng = np.random.default_rng(seed)
    sal = rng.uniform(0, 1, size=shape).astype(np.float32)
    sal[sal > occupancy] = 0.0
    v = rng.normal(size=shape + (3,)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    mask = (rng.uniform(size=shape) > 0.25).astype(np.float32)
    return sal, v, mask


def _top5(seed, shape=SHAPE):
    """A scattered field as -tv-best 0.05 leaves one: the top 5% of a
    random score, zero elsewhere."""
    rng = np.random.default_rng(seed)
    score = rng.normal(size=shape).astype(np.float32)
    return np.where(score >= np.quantile(score, 0.95), score, 0.0).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-5)


CASES = {
    # name: (hw, exponent, curves, masked, sparse, nvec channel-major)
    "hw1_e2": (1, 2, False, False, False, False),
    "hw2_e3_cm": (2, 3, False, False, False, True),
    "hw3_e4_sparse": (3, 4, False, False, True, False),
    "hw2_e4_mask_den": (2, 4, False, True, False, True),
    "hw2_e4_curves": (2, 4, True, False, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tv_votes_twin_matches_jax_kernel(case):
    hw, e, curves, masked, sparse, cm = CASES[case]
    sal, v, mask = _fields(100 + list(CASES).index(case),
                           occupancy=0.05 if sparse else 0.6)
    nv = np.moveaxis(v, -1, 0) if cm else v
    kw = dict(exponent=e, detect_curves=curves, truncate_ratio=RATIO,
              want_denominator=masked, sparse=sparse, channel_major=True,
              nvec_channel_major=cm)
    want, want_den = tv_dense_stick_pallas(
        jnp.asarray(sal), jnp.asarray(nv), _sigma(hw),
        mask_src=jnp.asarray(mask) if masked else None, interpret=True,
        **kw)
    got, got_den = tv_votes(
        to_torch(sal), to_torch(nv), _sigma(hw),
        mask_src=to_torch(mask) if masked else None, **kw)
    assert got.shape == (6,) + SHAPE
    _close(to_numpy(got), want)
    if masked:
        _close(to_numpy(got_den), want_den)
    else:
        assert got_den is None and want_den is None


def test_tv_votes_layouts_and_ambiguity():
    sal, v, _ = _fields(3)
    a, _ = tv_votes(to_torch(sal), to_torch(v), _sigma(1),
                    truncate_ratio=RATIO)                 # (Z, Y, X, 6)
    b, _ = tv_votes(to_torch(sal), to_torch(v, channels_last=True),
                    _sigma(1), truncate_ratio=RATIO, channel_major=True)
    assert a.shape == SHAPE + (6,)
    np.testing.assert_array_equal(to_numpy(a), to_numpy(b, channels_last=True))
    with pytest.raises(ValueError, match="ambiguous"):
        tv_votes(torch.ones(3, 3, 3), torch.ones(3, 3, 3, 3), _sigma(1))


@pytest.mark.parametrize("masked", [False, True])
def test_tv_dense_stick_normalized_matches_jax(masked):
    """Both normalisations: by the masked denominator, and without a
    mask by the separable box (off-diagonals divided twice)."""
    sal, v, mask = _fields(11)
    m = mask if masked else None
    kw = dict(exponent=4, truncate_ratio=2.5, normalize=True)
    want = JTV.tv_dense_stick(
        jnp.asarray(sal), jnp.asarray(v), 0.9,
        mask_src=None if m is None else jnp.asarray(m),
        mask_dest=None if m is None else jnp.asarray(m), **kw)
    got = TTV.tv_dense_stick(
        to_torch(sal), to_torch(v), 0.9,
        mask_src=None if m is None else to_torch(m),
        mask_dest=None if m is None else to_torch(m), **kw)
    _close(to_numpy(got), want)


def test_tv_accumulate_padded_matches_jax():
    sal, v, mask = _fields(12, shape=(8, 10, 12))
    w, rhat, hw = TTV.tv_tables(_sigma(2), RATIO)
    offs = JTV.tv_tables(_sigma(2), RATIO)[2]
    pad = [(hw, hw)] * 3
    args = (np.pad(sal, pad), np.pad(v, pad + [(0, 0)]), np.pad(mask, pad))
    want = JTV.tv_accumulate_padded(
        *[jnp.asarray(a) for a in args], sal.shape, jnp.asarray(w),
        jnp.asarray(rhat), jnp.asarray(offs), 4, False, hw, True)
    got = TTV.tv_accumulate_padded(
        *[to_torch(a) for a in args], sal.shape, w, rhat, 4, False, hw,
        True)
    for g, wnt in zip(got, want):
        _close(to_numpy(g), wnt)


# (sigma, truncate ratio) -> the window halfwidths 1, 3, 8 and 9
TAP_CASES = {"hw1": (0.9, 1.5), "hw3": (1.5, 2.5), "hw8": (3.3, 2.5),
             "hw9": (3.7, 2.5)}


@pytest.mark.parametrize("case", list(TAP_CASES))
def test_tap_list_is_the_nonzero_taps_in_raster_order(case):
    """The kernel's compact tap list: the non-zero-weight entries of
    tv_tables, bit for bit and in its raster order, at the positions
    the Pallas kernel does not skip (its gen_gauss_kernel_3d table)."""
    sigma, ratio = TAP_CASES[case]
    offs, w, rhat, hw = TC.tap_list(sigma, ratio)
    assert hw == int(case[2:])
    w_all, rhat_all, _ = TC.tv_tables(sigma, ratio)
    keep = np.flatnonzero(w_all)
    np.testing.assert_array_equal(w, w_all[keep])
    np.testing.assert_array_equal(rhat, rhat_all[keep])
    assert w.dtype == rhat.dtype == np.float32 and (w != 0).all()
    w_len = 2 * hw + 1
    raster = ((offs[:, 0] + hw) * w_len + offs[:, 1] + hw) * w_len \
        + offs[:, 2] + hw
    np.testing.assert_array_equal(raster, keep)
    ker = JK.gen_gauss_kernel_3d((sigma,) * 3, 2.0, (hw,) * 3)
    np.testing.assert_array_equal(np.flatnonzero(ker.ravel() != 0), keep)
    # the kernel's tables walk the same taps: per tap plane, the window
    # bitmask's set bits in order give the compact indices of the plane
    taps, meta, _ = TC._kernel_tables(sigma, ratio)
    np.testing.assert_array_equal(taps[:, 0], w)
    np.testing.assert_array_equal(taps[:, 1:], rhat)
    n_words = (w_len * w_len + 31) // 32
    pstart = meta[:w_len + 1]
    wmask = meta[w_len + 1:w_len + 1 + w_len * n_words].view(
        np.uint32).reshape(w_len, n_words)
    wbase = meta[w_len + 1 + w_len * n_words:
                 w_len + 1 + 2 * w_len * n_words].reshape(w_len, n_words)
    toff = meta[w_len + 1 + 2 * w_len * n_words:]
    assert len(toff) == len(w) and pstart[-1] == len(w)
    for tz in range(w_len):
        walked = []
        for wd in range(n_words):
            bits = int(wmask[tz, wd])
            for b in range(32):
                if bits >> b & 1:
                    k = wbase[tz, wd] + bin(bits & ((1 << b) - 1)).count("1")
                    ty, tx = divmod(32 * wd + b, w_len)
                    assert tuple(offs[k] + hw) == (tz, ty, tx)
                    assert toff[k] == ((2 * hw - ty) * (32 + 2 * hw)
                                       + 2 * hw - tx)
                    walked.append(k)
        assert walked == list(range(pstart[tz], pstart[tz + 1]))


@pytest.mark.parametrize("want_den", [False, True])
def test_smem_plan_fits_up_to_the_cap(want_den):
    """The voting kernel's shared-memory plan fits a Hopper block for
    every halfwidth up to MAX_KERNEL_HALFWIDTH, and the cap is where the
    plan (or the kernel's 128-bit staged row) stops."""
    for hw in range(TC.MAX_KERNEL_HALFWIDTH + 1):
        rows, nbytes = TC.smem_plan(hw, want_den)
        ry, sx = rows + 2 * hw, 32 + 2 * hw
        assert rows in (8, 4, 2, 1) and sx <= 128
        assert nbytes == (2 * ry * sx * (20 if want_den else 16)
                          + ry * 16) <= 232448
    assert TC.smem_plan(TC.MAX_KERNEL_HALFWIDTH + 1, True) is None
    assert TC.smem_plan(3, want_den)[0] == 8
