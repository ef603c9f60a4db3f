"""The PyTorch port's eigen stages (ops/eigen_cuda: the Hessian +
principal eigensolve + score, and the vote tensor's eigen score)
against the JAX package's Pallas kernels (interpret mode) and its XLA
chain (hessian_fd -> principal_sym3 -> score).

Tolerances as tests/test_eigen_pallas.py: the planar score rtol 1e-5,
atol 1e-6 of its largest magnitude; eigenvalues, stick and linear
scores rtol 1e-4, atol 1e-5 of the largest magnitude (differences of
nearly equal eigenvalues).  Eigenvectors are compared up to sign, where
the principal eigenvalue is well separated.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visfd_tpu.features import hessian as JH
from visfd_tpu.linalg import sym3 as jsym3
from visfd_tpu.ops.eigen_pallas import (hessian_principal_pallas,
                                        sym3_score_pallas)
from visfd_tpu_torch.convert import to_numpy, to_torch
from visfd_tpu_torch.features import hessian as TH
from visfd_tpu_torch.linalg import sym3 as tsym3
from visfd_tpu_torch.ops import eigen_cuda as EC

SIGMA = 1.7


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def blur():
    rng = np.random.default_rng(0)
    return rng.normal(size=(12, 20, 33)).astype(np.float32)


@pytest.fixture(scope="module")
def t6():
    rng = np.random.default_rng(7)
    return rng.normal(size=(6, 9, 17, 40)).astype(np.float32)


def _tol(formula):
    return (1e-5, 1e-6) if formula == "planar" else (1e-4, 1e-5)


def _close(got, want, formula):
    rtol, atol = _tol(formula)
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * np.abs(want).max())


def _same_direction(v, v_ref, vals):
    """|v . v_ref| ~ 1 where the principal eigenvalue is separated;
    v, v_ref channel-last (..., 3), vals (..., 3) in solver order."""
    gap = np.abs(vals[..., 0] - vals[..., 1])
    well = gap > 1e-3 * np.abs(vals).max()
    assert well.mean() > 0.95
    dot = np.abs((v * v_ref).sum(-1))
    assert dot[well].min() > 1 - 1e-4


def _xla_chain(blur, decreasing):
    order = (jsym3.EigenOrder.DECREASING if decreasing
             else jsym3.EigenOrder.INCREASING)
    hess = JH.hessian_fd(jnp.asarray(blur)) * (SIGMA * SIGMA)
    vals, v = jsym3.principal_sym3(jsym3.flat_to_full(hess), order=order)
    return np.asarray(vals), np.asarray(v)


@pytest.mark.parametrize("formula,decreasing", [
    ("planar", True), ("planar", False), ("linear", True),
    ("linear", False), ("stick", True), ("vals", False)])
def test_hessian_principal_matches_jax(blur, formula, decreasing):
    want_s, want_v = hessian_principal_pallas(
        jnp.asarray(blur), SIGMA, decreasing=decreasing, formula=formula,
        want_v=True, interpret=True)
    got_s, got_v = EC.hessian_principal(to_torch(blur), SIGMA,
                                        decreasing=decreasing,
                                        formula=formula, want_v=True)
    _close(to_numpy(got_s), want_s, formula)
    vals, v_xla = _xla_chain(blur, decreasing)
    got_v = to_numpy(got_v, channels_last=True)
    _same_direction(got_v, np.moveaxis(np.asarray(want_v), 0, -1), vals)
    _same_direction(got_v, v_xla, vals)
    if formula == "vals":
        _close(to_numpy(got_s, channels_last=True), vals, formula)


def test_hessian_principal_edge_faces(blur):
    """The faces take the nearest interior voxel's result (to float32
    rounding: the twin's vector and scalar loops may round one voxel
    differently), and agree with the JAX kernel there."""
    got, _ = EC.hessian_principal(to_torch(blur), SIGMA, formula="planar",
                                  want_v=False)
    s = to_numpy(got)
    for a, b in [(np.s_[0], np.s_[1]), (np.s_[-1], np.s_[-2])]:
        for face, inner in [(s[a], s[b]), (s[:, a], s[:, b]),
                            (s[:, :, a], s[:, :, b])]:
            np.testing.assert_allclose(face, inner, rtol=1e-5, atol=0)
    want, _ = hessian_principal_pallas(jnp.asarray(blur), SIGMA,
                                       formula="planar", want_v=False,
                                       interpret=True)
    want = np.asarray(want)
    for face in [np.s_[0, :, :], np.s_[-1, :, :], np.s_[:, 0, :],
                 np.s_[:, -1, :], np.s_[:, :, 0], np.s_[:, :, -1]]:
        np.testing.assert_allclose(s[face], want[face], rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def test_sym3_plain_math_matches_jax(t6):
    """principal_sym3 and its pieces against the JAX functions."""
    t6_last = np.moveaxis(t6, 0, -1)
    m_j = jsym3.flat_to_full(jnp.asarray(t6_last))
    m_t = tsym3.flat_to_full(to_torch(t6_last))
    np.testing.assert_array_equal(to_numpy(m_t), np.asarray(m_j))
    np.testing.assert_allclose(to_numpy(tsym3._compute_roots3(m_t)),
                               np.asarray(jsym3._compute_roots3(m_j)),
                               rtol=1e-4, atol=1e-5)
    vals_j, v_j = jsym3.principal_sym3(m_j)
    vals_t, v_t = tsym3.principal_sym3(m_t)
    _close(to_numpy(vals_t), vals_j, "vals")
    _same_direction(to_numpy(v_t), np.asarray(v_j), np.asarray(vals_j))


@pytest.mark.parametrize("formula,decreasing", [
    ("stick", True), ("stick", False), ("linear", True),
    ("planar", True), ("vals", True)])
def test_sym3_score_matches_jax(t6, formula, decreasing):
    want_s, want_v = sym3_score_pallas(jnp.asarray(t6),
                                       decreasing=decreasing,
                                       formula=formula, want_v=True,
                                       interpret=True)
    got_s, got_v = EC.sym3_score(to_torch(t6), decreasing=decreasing,
                                 formula=formula, want_v=True)
    _close(to_numpy(got_s), want_s, formula)
    order = (jsym3.EigenOrder.DECREASING if decreasing
             else jsym3.EigenOrder.INCREASING)
    vals, _ = jsym3.principal_sym3(
        jsym3.flat_to_full(jnp.asarray(np.moveaxis(t6, 0, -1))), order=order)
    _same_direction(to_numpy(got_v, channels_last=True),
                    np.moveaxis(np.asarray(want_v), 0, -1), np.asarray(vals))


@pytest.mark.parametrize("masked", [False, True])
def test_calc_hessian_matches_jax(blur, masked):
    """The plain blur -> (gradient * sigma, Hessian * sigma^2) chain."""
    rng = np.random.default_rng(9)
    mask = (rng.uniform(size=blur.shape) > 0.3).astype(np.float32)
    m_j = jnp.asarray(mask) if masked else None
    m_t = to_torch(mask) if masked else None
    g_j, h_j = JH.calc_hessian(jnp.asarray(blur), 1.3, mask=m_j)
    g_t, h_t = TH.calc_hessian(to_torch(blur), 1.3, mask=m_t)
    for got, want in ((g_t, g_j), (h_t, h_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def test_scores_match_jax():
    rng = np.random.default_rng(5)
    e = rng.normal(size=(4, 5, 6, 3)).astype(np.float32)
    for name in ("score_hessian_planar", "score_hessian_linear",
                 "score_tensor_planar", "score_tensor_linear"):
        np.testing.assert_allclose(
            to_numpy(getattr(TH, name)(to_torch(e))),
            np.asarray(getattr(JH, name)(jnp.asarray(e))), rtol=1e-6)


def _block_and_halos(x, z0, y0, bz, by):
    """The (bz, by, X) block of ``x`` at (z0, y0) and its four 1-deep
    halo slabs (z below and above with their y-corner rows, y before and
    after), cut from the volume zero-padded in z and y."""
    p = np.pad(x, ((1, 1), (1, 1), (0, 0)))
    z, y = z0 + 1, y0 + 1
    parts = (p[z:z + bz, y:y + by], p[z - 1, y - 1:y + by + 1],
             p[z + bz, y - 1:y + by + 1], p[z:z + bz, y - 1],
             p[z:z + bz, y + by])
    return [to_torch(np.ascontiguousarray(a)) for a in parts]


@pytest.mark.parametrize("bz", [1, 2, 3, 12])
@pytest.mark.parametrize("by", [1, 2, 3, 12])
def test_hessian_block_twin_matches_single_device_twin(bz, by):
    """The per-shard entry's twin on each block of a 3 x 3 grid of (bz,
    by) blocks, beside its halo slabs, assembled and its faces clamped,
    against the single-device twin: to the sharded eigen tolerance of
    tests/test_torch_mesh.py (the twins' vectorised transcendentals may
    round a voxel differently with the tensor's shape)."""
    x = np.random.default_rng(11).normal(
        size=(3 * bz, 3 * by, 13)).astype(np.float32)
    out = torch.empty((4,) + x.shape)
    for iz in range(3):
        for iy in range(3):
            out[:, iz * bz:(iz + 1) * bz, iy * by:(iy + 1) * by] = \
                EC.hessian_principal_block(
                    *_block_and_halos(x, iz * bz, iy * by, bz, by), SIGMA)
    EC.clamp_faces(out)
    want = to_numpy(EC.hessian_principal_plain(to_torch(x), SIGMA))
    got = to_numpy(out)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5,
                               atol=np.abs(want[0]).max() * 1e-6)
    well = want[0] > np.abs(want[0]).max() * 1e-3
    assert np.abs((got[1:] * want[1:]).sum(0))[well].min() > 1 - 1e-4


def test_hessian_block_refuses_wrong_halo_shapes():
    parts = _block_and_halos(np.zeros((4, 5, 6), np.float32), 0, 0, 4, 5)
    EC.hessian_principal_block(*parts, SIGMA)
    for i, bad in ((1, parts[1][1:]), (3, parts[3][:, 1:]),
                   (0, parts[0][:, :, :2])):
        with pytest.raises(ValueError, match="hessian_principal_block"):
            EC.hessian_principal_block(*parts[:i], bad, *parts[i + 1:],
                                       SIGMA)


def test_hessian_prepadded_is_the_block_entry_on_views():
    """The JAX package's per-shard interface (a padded block) runs the
    per-shard entry on views of it: the same floats."""
    rng = np.random.default_rng(12)
    xp = to_torch(rng.normal(size=(7, 9, 11)).astype(np.float32))
    for formula in ("planar", "vals"):
        got = EC.hessian_principal_prepadded(xp, SIGMA, formula=formula)
        want = EC.hessian_principal_block(
            xp[1:-1, 1:-1, 1:-1], xp[0, :, 1:-1], xp[-1, :, 1:-1],
            xp[1:-1, 0, 1:-1], xp[1:-1, -1, 1:-1], SIGMA, formula=formula)
        np.testing.assert_array_equal(to_numpy(got), to_numpy(want))


@pytest.fixture(scope="module")
def hess6():
    """A (6, 7, 8, 6) field of symmetric tensors and a mask."""
    rng = np.random.default_rng(51)
    h = rng.normal(size=(6, 7, 8, 6)).astype(np.float32)
    mask = (rng.uniform(size=(6, 7, 8)) > 0.3).astype(np.float32)
    return h, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("order", ["DECREASING_ABS", "INCREASING"])
def test_diagonalize_hessian_image_matches_jax(hess6, masked, order):
    """Eigenvalues to rtol 1e-4 / atol 1e-5 of the largest (the closed
    form's float32 roundings in another order); the Shoemake coordinates
    through the rebuild, port and JAX to the same tolerance of the input
    (a rotation has several encodings); masked voxels zero in both."""
    h, mask = hess6
    m = mask if masked else None
    want = np.asarray(JH.diagonalize_hessian_image(
        jnp.asarray(h), None if m is None else jnp.asarray(m),
        order=getattr(jsym3.EigenOrder, order)))
    got = TH.diagonalize_hessian_image(
        torch.tensor(h), None if m is None else torch.tensor(m),
        order=getattr(tsym3.EigenOrder, order))
    scale = float(np.abs(h).max())
    np.testing.assert_allclose(got[..., :3].numpy(), want[..., :3],
                               rtol=1e-4, atol=1e-5 * scale)
    back = TH.undiagonalize_hessian_image(
        got, None if m is None else torch.tensor(m)).numpy()
    jback = np.asarray(JH.undiagonalize_hessian_image(
        jnp.asarray(want), None if m is None else jnp.asarray(m)))
    keep = h if m is None else h * (m != 0)[..., None]
    np.testing.assert_allclose(back, keep, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(jback, keep, rtol=1e-4, atol=1e-5 * scale)
    if masked:
        assert (got.numpy()[mask == 0] == 0).all()
        assert (back[mask == 0] == 0).all()


def test_undiagonalize_and_flat_eigenvectors_match_jax(hess6):
    """On the same [eivals, shoemake] input the rebuild and the unpacking
    are the same float32 formulas: rtol 1e-5, atol 1e-6 of the largest."""
    h, _ = hess6
    diag = np.asarray(jsym3.diagonalize_flat_sym3(jnp.asarray(h)))
    want = np.asarray(jsym3.undiagonalize_flat_sym3(jnp.asarray(diag)))
    got = tsym3.undiagonalize_flat_sym3(torch.tensor(diag)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    jvals, jvecs = jsym3.flat_eigenvectors(jnp.asarray(diag))
    tvals, tvecs = tsym3.flat_eigenvectors(torch.tensor(diag))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    np.testing.assert_allclose(tvecs.numpy(), np.asarray(jvecs), rtol=1e-5,
                               atol=1e-6)
    # the rows are orthonormal eigenvectors of the input
    m = tsym3.flat_to_full(torch.tensor(h))
    av = torch.einsum("...ij,...dj->...di", m, tvecs)
    np.testing.assert_allclose(av.numpy(), (tvals[..., None] * tvecs).numpy(),
                               atol=1e-4 * float(np.abs(h).max()))
