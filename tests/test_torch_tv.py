"""The PyTorch port's stick tensor voting (ops/tv_cuda, features/tv)
against the JAX package: its Pallas voting kernel in interpret mode and
its XLA tv_dense_stick.

On the CPU the port takes the kernel's plain twin; the CUDA kernel is
held against that twin on a card, dense and sparse.  Tolerance: rtol
2e-4, atol 2e-5 (tests/test_tv_pallas.py: up to 343 float32 vote terms
summed in another order); sparse against dense on the card: rtol 3e-7.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visfd_tpu.features import tv as JTV
from visfd_tpu.ops.tv_pallas import tv_dense_stick_pallas
from visfd_tpu_torch.convert import to_numpy, to_torch
from visfd_tpu_torch.features import tv as TTV
from visfd_tpu_torch.ops.tv_cuda import tv_votes

SHAPE = (12, 20, 36)
RATIO = float(np.sqrt(2.0))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this on one)")
    return torch.device("cuda")


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


@pytest.mark.parametrize("case", list(CASES))
def test_tv_cuda_kernel_matches_twin(cuda, case):
    hw, e, curves, masked, _, cm = CASES[case]
    sal, v, mask = _fields(21, occupancy=0.05)
    nv = np.moveaxis(v, -1, 0) if cm else v
    kw = dict(exponent=e, detect_curves=curves, truncate_ratio=RATIO,
              want_denominator=masked, channel_major=True,
              nvec_channel_major=cm)
    want, want_den = tv_votes(to_torch(sal), to_torch(nv), _sigma(hw),
                              mask_src=to_torch(mask) if masked else None,
                              **kw)
    outs = []
    for sparse in (False, True):
        got, got_den = tv_votes(
            to_torch(sal, cuda), to_torch(nv, cuda), _sigma(hw),
            mask_src=to_torch(mask, cuda) if masked else None,
            sparse=sparse, **kw)
        torch.cuda.synchronize()
        _close(to_numpy(got), to_numpy(want))
        if masked:
            _close(to_numpy(got_den), to_numpy(want_den))
        outs.append(to_numpy(got))
    np.testing.assert_allclose(outs[1], outs[0], rtol=3e-7, atol=0)
