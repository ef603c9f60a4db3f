"""The PyTorch port's -connect modules against the JAX package, on seeded
numpy inputs run through both:

* ``linalg/sym3``: ``diagonalize_sym3`` for all six orders and
  ``diagonalize_flat_sym3``, eigenvalues to rtol 1e-5 (atol 1e-5 of the
  largest magnitude), eigenvectors up to sign where their eigenvalue is
  separated by 1e-3 of the largest; the quaternion and Shoemake codecs
  to 1e-6;
* ``segment/extrema.find_extrema``: the fast path, plateaus and the
  plateau-heavy fallback give equal seeds, scores and sizes;
* ``segment/connect.discard_gates``: margin-aware -- the discard masks
  are equal wherever a gate's two sides differ by more than 1e-5 of the
  larger (transcendentals differ by an ulp between torch and XLA); the
  z slabs give the whole volume's bits;
* ``_candidate_bound_f32`` at thresholds next to float32 boundaries;
* ``label_connected`` (compact and dense, both seed signs, must-link,
  both sort criteria, a mask): equal labels and cluster statistics; the
  native flood equal to its twin ``_flood_python``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visfd_tpu.features import hessian as JH
from visfd_tpu.linalg import sym3 as jsym3
from visfd_tpu.ops.filters import apply_gauss
from visfd_tpu.segment import connect as JC
from visfd_tpu.segment import extrema as JE
from visfd_tpu_torch import native
from visfd_tpu_torch.features.hessian import fd_slab, hessian_fd
from visfd_tpu_torch.linalg import sym3 as tsym3
from visfd_tpu_torch.segment import connect as TC
from visfd_tpu_torch.segment import extrema as TE

SHAPE = (11, 14, 17)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _smooth(shape, seed, sigma=1.5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    return np.asarray(apply_gauss(jnp.asarray(x), sigma))


@pytest.fixture(scope="module")
def fields():
    """(saliency, channel-last tensor, channel-last vector, mask)."""
    rng = np.random.default_rng(5)
    sal = _smooth(SHAPE, 5)
    t6 = rng.normal(size=SHAPE + (6,)).astype(np.float32)
    v3 = rng.normal(size=SHAPE + (3,)).astype(np.float32)
    mask = (rng.uniform(size=SHAPE) > 0.1).astype(np.float32)
    return sal, t6, v3, mask


def _cm(a):
    """A channel-last numpy field as the port's channel-major tensor."""
    return torch.tensor(np.moveaxis(a, -1, 0))


def _sym_mats(n, seed):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n, 6)).astype(np.float32)
    f[:50, 3:] = 0.0                  # diagonal
    f[50:80] = 0.0                    # zero
    f[80:110, :3] = 2.0               # isotropic
    f[80:110, 3:] = 0.0
    f[110:140, 1] = f[110:140, 0]     # a double eigenvalue
    f[110:140, 3] = 0.0
    return f


def _vectors_agree(v_j, v_t, vals):
    """|v . v'| >= 1 - 1e-5 wherever the eigenvalue is separated from
    both others by 1e-3 of the largest magnitude."""
    scale = np.abs(vals).max()
    ok = True
    for i in range(3):
        gaps = [np.abs(vals[:, i] - vals[:, k]) for k in range(3) if k != i]
        sep = np.minimum(*gaps) > 1e-3 * scale
        dots = np.abs((v_j[:, i] * v_t[:, i]).sum(-1))
        ok &= bool((dots[sep] >= 1 - 1e-5).all())
    return ok


@pytest.mark.parametrize("order", list(jsym3.EigenOrder),
                         ids=lambda o: o.value)
def test_diagonalize_sym3_matches_jax(order):
    f = _sym_mats(600, 1)
    m = np.asarray(jsym3.flat_to_full(jnp.asarray(f)))
    vj, ej = jsym3.diagonalize_sym3(jnp.asarray(m), order=order)
    vt, et = tsym3.diagonalize_sym3(torch.tensor(m),
                                    order=tsym3.EigenOrder(order.value))
    vj, ej = np.asarray(vj), np.asarray(ej)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-5,
                               atol=1e-5 * np.abs(vj).max())
    assert _vectors_agree(ej, et.numpy(), vj)
    # rows of a rotation: orthonormal
    g = np.einsum("nij,nkj->nik", et.numpy(), et.numpy())
    np.testing.assert_allclose(g, np.broadcast_to(np.eye(3), g.shape),
                               atol=1e-5)


def test_diagonalize_flat_sym3_matches_jax():
    f = _sym_mats(600, 2)
    dj = np.asarray(jsym3.diagonalize_flat_sym3(
        jnp.asarray(f), order=jsym3.EigenOrder.DECREASING))
    dt = tsym3.diagonalize_flat_sym3(torch.tensor(f),
                                     order=tsym3.EigenOrder.DECREASING)
    np.testing.assert_allclose(dt[:, :3].numpy(), dj[:, :3], rtol=1e-5,
                               atol=1e-5 * np.abs(dj[:, :3]).max())
    ej = np.asarray(jsym3.shoemake_to_matrix(jnp.asarray(dj[:, 3:])))
    et = tsym3.shoemake_to_matrix(dt[:, 3:]).numpy()
    assert _vectors_agree(ej, et, dj[:, :3])
    # the det > 0 fix-up: a proper rotation whatever the solver's signs
    np.testing.assert_allclose(np.linalg.det(et), 1.0, atol=1e-5)


def test_rotation_codecs_match_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(500, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    m = np.asarray(jsym3.quaternion_to_matrix(jnp.asarray(q, jnp.float32)))
    m_t = tsym3.quaternion_to_matrix(torch.tensor(q, dtype=torch.float32))
    np.testing.assert_allclose(m_t.numpy(), m, atol=1e-6)
    sm = np.asarray(jsym3.matrix_to_shoemake(jnp.asarray(m)))
    sm_t = tsym3.matrix_to_shoemake(torch.tensor(m)).numpy()
    np.testing.assert_allclose(sm_t, sm, atol=1e-6)
    np.testing.assert_allclose(
        tsym3.shoemake_to_matrix(torch.tensor(sm)).numpy(), m, atol=1e-5)
    f = _sym_mats(40, 4)
    np.testing.assert_array_equal(
        tsym3.full_to_flat(tsym3.flat_to_full(torch.tensor(f))).numpy(), f)


def _extrema_inputs():
    x = _smooth(SHAPE, 8)
    plat = x.copy()
    plat[3, 4, 2:4] = x.max() + 1.0           # a maximum plateau
    plat[8, 9:11, 9] = x.min() - 1.0          # a minimum plateau
    plat[0, 0, :3] = x.max() + 2.0            # one on the border
    ints = np.round(x * 3).astype(np.float32)  # plateau-heavy
    nan = x.copy()
    nan[5, 5, 5] = np.nan
    return {"smooth": x, "plateaus": plat, "integers": ints, "nan": nan}


@pytest.mark.parametrize("case", ["smooth", "plateaus", "integers", "nan"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(connectivity=1, minima_threshold=-0.05, maxima_threshold=0.05),
    dict(connectivity=2, allow_borders=False, masked=True),
], ids=["conn3", "conn1-thresholds", "conn2-noborders-masked"])
def test_find_extrema_matches_jax(case, kw):
    x = _extrema_inputs()[case]
    kw = dict(kw)
    mask = None
    if kw.pop("masked", False):
        mask = np.ones(SHAPE, np.float32)
        mask[:, :, :3] = 0.0
        mask[4, 5:8, 6:10] = 0.0
    want = JE.find_extrema(x, mask=mask, **kw)
    got = TE.find_extrema(torch.tensor(x),
                          mask=None if mask is None else torch.tensor(mask),
                          **kw)
    # (no extremum of the integer image avoids the mask and the borders)
    assert want.num_extrema > 0 or case == "integers"
    for f in ("minima_indices", "minima_scores", "minima_nvoxels",
              "maxima_indices", "maxima_scores", "maxima_nvoxels",
              "label_image"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_find_extrema_takes_both_paths(monkeypatch):
    """The fast path serves the plateau case and the propagation the
    integer image (so the cases above test both)."""
    calls = []
    real = TE._extrema_device
    monkeypatch.setattr(TE, "_extrema_device",
                        lambda *a: calls.append(1) or real(*a))
    inputs = _extrema_inputs()
    TE.find_extrema(torch.tensor(inputs["plateaus"]))
    assert not calls
    TE.find_extrema(torch.tensor(inputs["integers"]))
    assert calls


@pytest.mark.parametrize("z0,z1", [(0, 11), (0, 1), (0, 4), (3, 7), (10, 11),
                                   (9, 11)])
def test_hessian_slab_equals_whole_volume(fields, z0, z1):
    sal = torch.tensor(fields[0])
    want = hessian_fd(sal)[z0:z1]
    got = fd_slab(sal, z0, z1, 0, sal.shape[1])
    assert torch.equal(got, want)


def _jax_gate_margins(sal, t6, v3, thr_t, thr_v, consider_sign, order):
    """|lhs - rhs| / max(|lhs|, |rhs|) of each gate, from the JAX
    package's own quantities (the tensor gate, then the vector gate)."""
    hess = -JH.hessian_fd(jnp.asarray(sal))
    tp = JC.trace_product_sym3_quirk(hess, t6)
    fs = jnp.sqrt(jnp.maximum(JC.trace_product_sym3_quirk(hess, hess), 0.0))
    ft = jnp.sqrt(jnp.maximum(JC.trace_product_sym3_quirk(t6, t6), 0.0))
    sides = [(tp, jnp.float32(thr_t) * fs * ft)]
    diag = jsym3.diagonalize_flat_sym3(hess, order=order)
    v1 = jsym3.shoemake_to_matrix(diag[..., 3:6])[..., 0, :]
    dot = jnp.sum(v1 * v3, -1)
    lv1, lv = jnp.linalg.norm(v1, axis=-1), jnp.linalg.norm(v3, axis=-1)
    if consider_sign:
        sides.append((dot, jnp.float32(thr_v) * lv1 * lv))
    else:
        sides.append((dot * dot,
                      jnp.float32(thr_v ** 2) * lv1 * lv1 * lv * lv))
    out = []
    for lhs, rhs in sides:
        lhs, rhs = np.asarray(lhs, np.float64), np.asarray(rhs, np.float64)
        out.append(np.abs(lhs - rhs)
                   / np.maximum(np.maximum(np.abs(lhs), np.abs(rhs)), 1e-300))
    return out


@pytest.mark.parametrize("consider_sign", [False, True])
def test_discard_gates_match_jax_margin_aware(fields, consider_sign):
    sal, t6, v3, _ = fields
    thr_t, thr_v = 0.3, 0.5
    order = jsym3.EigenOrder.DECREASING
    want = np.asarray(JC._discard_gates_device(
        jnp.asarray(sal), jnp.asarray(t6), jnp.asarray(v3),
        jnp.float32(thr_t), jnp.float32(thr_v), jnp.float32(thr_v ** 2),
        order=order, consider_sign=consider_sign, neg_hess=True,
        has_tensor=True, has_vector=True))
    args = (torch.tensor(sal), _cm(t6), _cm(v3), thr_t, thr_v,
            tsym3.EigenOrder.DECREASING, consider_sign, True)
    got = TC.discard_gates(*args).numpy()
    # one slab per plane: the same bits as one slab of the whole volume
    assert np.array_equal(TC.discard_gates(*args, slab_voxels=1).numpy(), got)
    m_t, m_v = _jax_gate_margins(sal, t6, v3, thr_t, thr_v, consider_sign,
                                 order)
    near = (m_t <= 1e-5) | (m_v <= 1e-5)
    print(f"{int(near.sum())} of {near.size} voxels within 1e-5 of a gate")
    assert 0.05 < want.mean() < 0.95    # both outcomes occur
    assert near.sum() <= 5
    np.testing.assert_array_equal(got[~near], want[~near])


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("thr", [1e9, 5e9, 37.0, 0.1, 1.0 / 3.0, 16777217.0,
                                 -2.5e-8, np.inf, -np.inf])
def test_candidate_bound_f32(sign, thr):
    t32, pred_gt = TC._candidate_bound_f32(thr, sign)
    assert (t32, pred_gt) == JC._candidate_bound_f32(thr, sign)
    assert t32.dtype == np.float32
    # float32 values around the threshold: the float32 predicate equals
    # the flood's float64 pop test
    c = np.float32(thr)
    vals = [np.nextafter(c, np.float32(d)) for d in (-np.inf, np.inf)]
    vals = np.asarray([c] + vals + [np.float32(0.0), np.float32(np.nan)],
                      np.float32)
    pops = vals.astype(np.float64) * sign > thr * sign
    cand = ~((vals > t32) if pred_gt else (vals < t32))
    assert np.array_equal(cand, ~pops)


CONNECT_CASES = {
    "plain": dict(),
    "minima": dict(start_from_saliency_maxima=False),
    "gates-unsigned": dict(
        gates=True, threshold_tensor_saliency=0.3,
        threshold_vector_saliency=0.2, threshold_tensor_neighbor=0.1,
        threshold_vector_neighbor=0.4, consider_dot_product_sign=False,
        standardize_vector_sign=True),
    "gates-signed": dict(
        gates=True, threshold_tensor_saliency=0.2,
        threshold_vector_saliency=0.1, threshold_tensor_neighbor=-0.2,
        consider_dot_product_sign=True),
    "must-link": dict(
        gates=True, threshold_tensor_saliency=-1.0,
        threshold_vector_saliency=0.0, threshold_tensor_neighbor=-1.0,
        threshold_vector_neighbor=0.0, consider_dot_product_sign=False,
        standardize_vector_sign=True,
        must_link=[[(2.2, 0.4, 5.0), (15.6, 3.0, 9.7)],
                   [(16.0, 13.0, 0.4), (10.0, 6.0, 4.0)]],
        must_link_directions=[["auto", "auto"], ["same", "opposite"]]),
    "by-value": dict(sort_criteria="value"),
}


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "dense"])
@pytest.mark.parametrize("case", list(CONNECT_CASES))
@pytest.mark.parametrize("masked", [False, True], ids=["", "masked"])
def test_label_connected_matches_jax(fields, compact, case, masked):
    sal, t6, v3, mask = fields
    kw = dict(CONNECT_CASES[case])
    kj, kt = dict(kw), dict(kw)
    if kw.pop("gates", False):
        kj.pop("gates"), kt.pop("gates")
        kj.update(tensor=t6, vector=v3)
        kt.update(tensor=_cm(t6), vector=_cm(v3))
    maxima = kw.get("start_from_saliency_maxima", True)
    thr = float(np.percentile(sal, 75 if maxima else 25))
    m = mask if masked else None
    want = JC.label_connected(sal, mask=m, threshold_saliency=thr,
                              compact=compact, **kj)
    got = TC.label_connected(torch.tensor(sal),
                             mask=None if m is None else torch.tensor(m),
                             threshold_saliency=thr, compact=compact, **kt)
    assert want.num_clusters > (1 if case == "must-link" else 2)
    assert got.num_clusters == want.num_clusters
    np.testing.assert_array_equal(got.labels, want.labels)
    for f in ("cluster_maxima", "cluster_sizes", "cluster_saliencies"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    if want.vector_standardized is None:
        assert got.vector_standardized is None
    else:
        np.testing.assert_array_equal(got.vector_standardized,
                                      want.vector_standardized)


def test_label_connected_without_seeds(fields):
    sal, _, v3, _ = fields
    res = TC.label_connected(torch.tensor(sal), threshold_saliency=1e30,
                             vector=_cm(v3), consider_dot_product_sign=False,
                             standardize_vector_sign=True)
    assert res.num_clusters == 0 and (res.labels == -1).all()


@pytest.mark.parametrize("gates", [False, True])
def test_native_flood_equals_python_twin(fields, gates):
    sal, t6, v3, mask = fields
    rng = np.random.default_rng(11)
    res = TE.find_extrema(torch.tensor(sal), connectivity=1,
                          find_minima=False, want_label_image=False)
    seeds = np.stack(TE.flat_to_xyz(res.maxima_indices, SHAPE), -1)
    discard = rng.uniform(size=SHAPE) < 0.05
    discard.reshape(-1)[res.maxima_indices[:3]] = True   # discarded seeds
    args = [sal, mask != 0, discard, seeds, res.maxima_scores, len(seeds),
            TE.neighbor_offsets(1), -1.0, float(np.percentile(sal, 40)),
            t6 if gates else None, v3 if gates else None, 0.1, 0.3, False]
    outs = [fn(*args, v3.copy() if gates else None)
            for fn in (TC._flood_native, TC._flood_python)]
    (lab_n, b2c_n, c2b_n, pol_n, vs_n, cut_n), \
        (lab_p, b2c_p, c2b_p, pol_p, vs_p, cut_p) = outs
    np.testing.assert_array_equal(lab_n, lab_p)
    np.testing.assert_array_equal(b2c_n, b2c_p)
    np.testing.assert_array_equal(pol_n, pol_p)
    assert cut_n == cut_p
    # the native map is rebuilt from basin2cluster: the twin's without
    # the basins whose seed was discarded
    assert c2b_n == [{b for b in c if b2c_p[b] >= 0} for c in c2b_p]
    if gates:
        np.testing.assert_array_equal(vs_n, vs_p)
    assert len(np.unique(lab_n)) > 3


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No hidden fallback: a source g++ rejects raises with the
    compiler's error; so does a missing compiler."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
