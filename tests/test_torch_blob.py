"""The port's blob detection (features/blob), sphere drawing
(ops/draw.draw_spheres) and supervised thresholds (features/supervised)
against the JAX package, and the blob ladder over (z, y) blocks against
one device.

Seeded numpy inputs go through both packages; the port runs its plain
twins on the CPU.  Tolerances:

* the 80-neighbour extremum masks, the NMS keep lists, the masked
  discard, the sort, ``draw_spheres`` and the supervised thresholds:
  exact;
* blob lists: coordinates and scales exact, scores rtol 1e-5 with an
  atol of 2^-22 max|x| / delta^2 (a score is a float32 difference of two
  blurs, each rounded to a few ulps of at most max|x|, scaled by
  1 / delta^2: near-zero scores keep only that absolute accuracy).  A
  candidate whose extremum margin min |neighbour - centre| / |centre|
  is below 1e-4 may be in one list only (two implementations' rounding
  decides a near-tie); such candidates are counted and printed, and
  the phantoms here have none;
* blockwise (-mesh) lists: bit for bit the single-device ones.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visfd_tpu.features import blob as JB
from visfd_tpu.features import supervised as JSUP
from visfd_tpu.ops import draw as JD
from visfd_tpu_torch.features import blob as TB
from visfd_tpu_torch.features import supervised as TSUP
from visfd_tpu_torch.ops import draw as TD
from visfd_tpu_torch.parallel.mesh import make_mesh
from visfd_tpu_torch.utils.phantom import blob_phantom
from visfd_tpu_torch.utils.progress import Report

MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def diameter_ladder(d_min, d_max, growth_ratio):
    """-blob ladder construction (settings.cpp:1702-1750)."""
    n = 1 + int(np.ceil(np.log(d_max / d_min) / np.log(growth_ratio)))
    g = (d_max / d_min) ** (1.0 / n)
    out = [d_min]
    for _ in range(1, n):
        out.append(out[-1] * g)
    return out


def assert_blob_lists_match(a, b, x, mask=None, diameters=None,
                            delta=0.02, **log_kw):
    """``a`` (JAX) against ``b`` (port): the common blobs' scores to rtol
    1e-5, atol 2^-22 max|x| / delta^2; a blob in one list only must be
    a near-tie (margin < 1e-4, computed on ``x``); returns how many such
    blobs there were."""
    ia, ib, only_a, only_b = TB.match_blob_lists(a, b)
    np.testing.assert_allclose(b.scores[ib], a.scores[ia], rtol=1e-5,
                               atol=2.0 ** -22 * np.abs(x).max() / delta ** 2)
    extra = [(a, i) for i in only_a] + [(b, i) for i in only_b]
    if extra:
        sig = [d / (2 * np.sqrt(3.0)) for d in diameters]
        for bl, i in extra:
            k = int(np.argmin(np.abs(np.asarray(sig) * 2 * np.sqrt(3.0)
                                     - bl.diameters[i])))
            zyx = bl.crds[i][::-1].astype(np.int64)
            mg = TB.extremum_margins(torch.tensor(x), sig, zyx[None], [k],
                                     None if mask is None
                                     else torch.tensor(mask), **log_kw)[0]
            print(f"near-tie blob {bl.crds[i]} d={bl.diameters[i]:.4g} "
                  f"score {bl.scores[i]:.6g}: margin {mg:.3g}")
            assert mg < MARGIN
    return len(extra)


# --- the 80-neighbour test ---------------------------------------------------

def _planted(seed, shape=(11, 14, 17)):
    """Three scales of noise with ties, NaN and plateaus planted."""
    rng = np.random.default_rng(seed)
    p, m, n = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    m[5, 6, 7] = -9.0            # a clear minimum
    m[2, 3, 4] = 9.0             # a clear maximum
    m[6, 9, 9] = -9.0
    p[6, 9, 10] = -9.0           # tied with a neighbour in the scale below
    m[8, 4, 12] = 8.0
    m[8, 4, 13] = 8.0            # tied within the scale
    m[3, 10, 3] = -8.0
    n[3, 11, 3] = np.nan         # a NaN neighbour disqualifies
    m[9, 2, 8] = np.nan          # a NaN centre is no extremum
    m[0, 7, 7] = -9.0            # on a face: out-of-bounds neighbours
    m[7, 10, 4] = 9.0            # a clear maximum in a masked-in box
    mask = (rng.uniform(size=shape) > 0.1).astype(np.float32)
    mask[4:7, 5:8, 6:9] = 1.0
    mask[6:9, 9:12, 3:6] = 1.0
    mask[2, 3, 5] = 0.0          # a masked neighbour of the maximum
    return p, m, n, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_extremum_masks_match_jax(seed, masked):
    p, m, n, mask = _planted(seed)
    k = mask if masked else None
    want = JB._extremum_masks(jnp.asarray(p), jnp.asarray(m), jnp.asarray(n),
                              None if k is None else jnp.asarray(k))
    got = TB._extremum_masks(torch.tensor(p), torch.tensor(m),
                             torch.tensor(n),
                             None if k is None else torch.tensor(k))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].any() and got[1].any()


def test_extremum_masks_of_smooth_volumes_match_jax():
    """Blurred noise (many genuine extrema, few ties)."""
    rng = np.random.default_rng(5)
    from scipy.ndimage import gaussian_filter
    vols = [gaussian_filter(rng.normal(size=(16, 20, 24)), 1.5).astype(
        np.float32) for _ in range(3)]
    want = JB._extremum_masks(*map(jnp.asarray, vols), None)
    got = TB._extremum_masks(*map(torch.tensor, vols), None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].sum()) > 3


def test_extremum_masks_slabs_equal_one_pass(monkeypatch):
    p, m, n, mask = _planted(3)
    args = [torch.tensor(a) for a in (p, m, n, mask)]
    whole = TB._extremum_masks(*args)
    monkeypatch.setattr(TB, "SLAB_VOXELS", 14 * 17 * 2)
    for g, w in zip(TB._extremum_masks(*args), whole):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


# --- the ladder and NMS -------------------------------------------------------

@pytest.mark.parametrize("slab_planes", [None, 2])
def test_scale_candidates_on_cpu_take_the_twin(monkeypatch, slab_planes):
    """CPU tensors take the plain twin slab by slab (the Report counts
    its slabs and no kernel launch; the kernel's wrapper refuses CPU
    tensors), and the candidates are the twin's masks AND the sign test
    in raster order, scored with the mid scale's values."""
    p, m, n, mask = _planted(4)
    args = [torch.tensor(a) for a in (p, m, n, mask)]
    if slab_planes:
        monkeypatch.setattr(TB, "SLAB_VOXELS", slab_planes * 14 * 17)
    launches = TB._extremum_codes_cuda.launches
    rep = Report(None)
    got = TB._scale_candidates(*args, rep)
    assert rep.counts[TB.TWIN_SLABS] == -(-11 // (slab_planes or 11))
    assert TB.KERNEL_LAUNCHES not in rep.counts
    assert TB._extremum_codes_cuda.launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        TB._extremum_codes_cuda(*args[:3], None)
    lo, hi = TB._extremum_masks(*args)
    for (zyx, sc), sel in zip(got, (lo & (args[1] < 0), hi & (args[1] > 0))):
        want = torch.nonzero(sel).numpy()
        assert len(want)
        np.testing.assert_array_equal(zyx, want)
        np.testing.assert_array_equal(sc, m[tuple(want.T)])


def test_blob_dog_records_the_extremum_counts():
    """blob_dog's Report holds the launch and twin-slab counts of its mid
    scales (on the CPU: every scale the twin, no launch)."""
    x, mask, _ = _phantom(seed=12, shape=(20, 24, 28))
    rep = Report(None)
    sig = [1.5, 1.8, 2.2, 2.6]
    TB.blob_dog(torch.tensor(x), sig, mask=torch.tensor(mask), report=rep)
    assert rep.counts[TB.TWIN_SLABS] == len(sig) - 2
    assert TB.KERNEL_LAUNCHES not in rep.counts


def _three_spheres():
    """tests/test_blob.py's three bright Gaussian blobs of diameter ~8."""
    n = 40
    centers = [(10, 10, 10), (10, 28, 28), (30, 18, 12)]
    z, y, x = np.meshgrid(*([np.arange(n, dtype=np.float64)] * 3),
                          indexing="ij")
    img = np.zeros((n, n, n))
    sigma_true = 8.0 / (2 * np.sqrt(3))
    for cz, cy, cx in centers:
        img += np.exp(-0.5 * ((z - cz) ** 2 + (y - cy) ** 2
                              + (x - cx) ** 2) / sigma_true ** 2)
    return img.astype(np.float32), centers


@pytest.mark.parametrize("sep", [1.0, 0.0])
def test_blob_dog_nm_three_spheres_match_jax(sep):
    """The maxima (with and without NMS) equal, the three spheres after
    NMS.  The minima lie in the troughs between the spheres, where the
    phantom's mirror symmetry makes exact ties (margin 0): there only
    the margin-aware comparison holds, which counts and prints them; the
    NMS's best-first order among tied scores is not compared."""
    img, centers = _three_spheres()
    diams = diameter_ladder(4.0, 16.0, 1.05)
    kw = dict(minima_threshold=0.5, maxima_threshold=0.5,
              use_threshold_ratios=True, sep_ratio_thresh=sep)
    jmin, jmax = JB.blob_dog_nm(jnp.asarray(img), diams, **kw)
    tmin, tmax = TB.blob_dog_nm(torch.tensor(img), diams, **kw)
    assert assert_blob_lists_match(jmax, tmax, img, None, diams) == 0
    np.testing.assert_array_equal(tmax.crds, jmax.crds)
    if sep == 0.0:
        n = assert_blob_lists_match(jmin, tmin, img, None, diams)
        print(f"{n} tied minima of {len(jmin)}")
        return
    assert {tuple(int(v) for v in c) for c in tmax.crds} == \
        {(cx, cy, cz) for cz, cy, cx in centers}


def _phantom(seed=11, shape=(36, 44, 52)):
    v, m, c, d = blob_phantom(shape, seed=seed, n_blobs=14, spacing=16,
                              diameters=(6.0, 9.0))
    return v.numpy(), m.numpy(), c


@pytest.mark.parametrize("masked", [False, True])
def test_blob_dog_masked_phantom_matches_jax(masked):
    """The raw ladder lists (no NMS, no ratio threshold) of a seeded
    phantom of dark spheres: every candidate's coordinates and scale
    exact, its score to rtol 1e-5."""
    x, mask, _ = _phantom()
    m = mask if masked else None
    diams = diameter_ladder(5.0, 11.0, 1.08)
    kw = dict(minima_threshold=0.0, maxima_threshold=0.0,
              use_threshold_ratios=False, sep_ratio_thresh=0.0,
              nonmax_max_overlap_large=np.inf,
              nonmax_max_overlap_small=np.inf, truncate_ratio=2.5)
    jmin, jmax = JB.blob_dog_nm(jnp.asarray(x), diams,
                                mask=None if m is None else jnp.asarray(m),
                                **kw)
    tmin, tmax = TB.blob_dog_nm(torch.tensor(x), diams,
                                mask=None if m is None else torch.tensor(m),
                                **kw)
    assert len(jmin) > 10 and len(jmax) > 10
    for a, b in ((jmin, tmin), (jmax, tmax)):
        assert assert_blob_lists_match(a, b, x, m, diams) == 0
        np.testing.assert_array_equal(b.crds, a.crds)
        np.testing.assert_array_equal(b.diameters, a.diameters)


def test_reference_ladder_near_ties_are_margin_flagged():
    """The reference's 1.01 ladder on the phantom: near-ties between
    neighbouring scales are where the two packages may differ; each
    blob found by one package only is a flagged near-tie."""
    x, mask, _ = _phantom(seed=12, shape=(30, 40, 44))
    diams = diameter_ladder(160.0 / 19.6, 280.0 / 19.6, 1.01)
    kw = dict(minima_threshold=0.0, maxima_threshold=-np.inf,
              use_threshold_ratios=False, sep_ratio_thresh=0.0,
              nonmax_max_overlap_large=np.inf,
              nonmax_max_overlap_small=np.inf, truncate_ratio=-1.0,
              truncate_threshold=0.03)
    jmin, _ = JB.blob_dog_nm(jnp.asarray(x), diams, mask=jnp.asarray(mask),
                             **kw)
    tmin, _ = TB.blob_dog_nm(torch.tensor(x), diams, mask=torch.tensor(mask),
                             **kw)
    assert len(tmin) > 10
    n = assert_blob_lists_match(
        jmin, tmin, x, mask, diams,
        truncate_ratio=float(np.sqrt(-2.0 * np.log(0.03))))
    print(f"{n} near-tie candidates of {len(jmin)}")


@pytest.mark.parametrize("crit", [JB.SORT_DECREASING_MAGNITUDE,
                                  JB.SORT_INCREASING, JB.SORT_DECREASING,
                                  JB.SORT_INCREASING_MAGNITUDE])
def test_sort_and_nms_match_jax(crit):
    rng = np.random.default_rng(21)
    n = 300
    crds = rng.uniform(0, 60, size=(n, 3))
    crds[::7] = np.round(crds[::7])
    diams = rng.uniform(2.0, 12.0, n)
    scores = rng.normal(size=n)
    scores[10:20] = scores[10]       # ties keep their order
    a = JB.BlobList(crds, diams, scores)
    b = TB.BlobList(crds.copy(), diams.copy(), scores.copy())
    for asc in (True, False):
        ja, tb = JB.sort_blobs(a, crit, asc), TB.sort_blobs(b, crit, asc)
        np.testing.assert_array_equal(tb.scores, ja.scores)
        np.testing.assert_array_equal(tb.crds, ja.crds)
    for sep, big, small in ((1.0, np.inf, np.inf), (0.6, np.inf, np.inf),
                            (0.0, 0.3, np.inf), (0.0, np.inf, 0.2)):
        ja = JB.discard_overlapping_blobs(a, sep, big, small, crit)
        tb = TB.discard_overlapping_blobs(b, sep, big, small, crit)
        assert 0 < len(tb) < n
        np.testing.assert_array_equal(tb.crds, ja.crds)
        np.testing.assert_array_equal(tb.scores, ja.scores)


def test_discard_masked_blobs_and_overlap_match_jax():
    rng = np.random.default_rng(22)
    mask = (rng.uniform(size=(10, 12, 14)) > 0.5).astype(np.float32)
    crds = rng.uniform(0, 9.4, size=(80, 3)) * [1.3, 1.15, 1.0]
    bl = (crds, np.ones(80), rng.normal(size=80))
    ja = JB.discard_masked_blobs(JB.BlobList(*bl), mask)
    tb = TB.discard_masked_blobs(TB.BlobList(*bl), mask)
    np.testing.assert_array_equal(tb.crds, ja.crds)
    assert 0 < len(tb) < 80
    for args in ((0.0, 2.0, 2.0), (3.0, 1.0, 2.0), (1.0, 1.0, 3.0),
                 (5.0, 2.0, 2.0)):
        assert TB.calc_sphere_overlap(*args) == JB.calc_sphere_overlap(*args)


# --- draw_spheres -------------------------------------------------------------

DRAW = {
    "plain": dict(),
    "shells": dict(shells=True),
    "mask": dict(mask=True),
    "foreground-normalize": dict(foreground_normalize=True, mask=True),
    "background": dict(background=True, background_rescale=0.5,
                       background_offset=-2.0),
    "background-normalize": dict(background=True, background_normalize=True,
                                 background_rescale=0.3, mask=True),
}


@pytest.mark.parametrize("case", list(DRAW))
def test_draw_spheres_match_jax(case):
    """Overlapping spheres (the later one wins), spheres crossing the
    faces, negative centre coordinates, shells, the mask and both
    normalisations: the same image bits."""
    opts = dict(DRAW[case])
    rng = np.random.default_rng(23)
    shape = (14, 17, 20)
    n = 40
    centres = rng.uniform(-2, 21, size=(n, 3))
    diams = rng.uniform(0.0, 9.0, n)
    diams[:4] = [0.0, 1.0, 2.0, 3.0]
    shell = (rng.uniform(0.0, 2.0, n) if opts.pop("shells", False)
             else diams / 2)
    fg = rng.normal(size=n)
    bg = rng.normal(size=shape).astype(np.float32)
    mask = (rng.uniform(size=shape) > 0.3).astype(np.float32)
    kw = dict(background=bg if opts.pop("background", False) else None,
              mask=mask if opts.pop("mask", False) else None, **opts)
    want = JD.draw_spheres(shape, centres, diams, shell, fg, **kw)
    got = TD.draw_spheres(shape, centres, diams, shell, fg, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != (0 if kw["background"] is None else got.numpy()
                            + 1)).any()


def test_draw_spheres_chunks_equal_one_pass(monkeypatch):
    rng = np.random.default_rng(24)
    shape = (12, 13, 15)
    centres = rng.uniform(0, 12, size=(60, 3))
    diams = rng.uniform(1.0, 7.0, 60)
    fg = rng.normal(size=60)
    whole = TD.draw_spheres(shape, centres, diams, None, fg)
    monkeypatch.setattr(TD, "PAIRS_PER_CHUNK", 50)
    np.testing.assert_array_equal(
        TD.draw_spheres(shape, centres, diams, None, fg).numpy(),
        whole.numpy())


# --- supervised ---------------------------------------------------------------

def _training(seed=25):
    rng = np.random.default_rng(seed)
    n = 60
    crds = rng.uniform(2, 38, size=(n, 3))
    diams = rng.uniform(3.0, 8.0, n)
    scores = rng.normal(size=n)
    pos = crds[scores < 0][:12] + rng.uniform(-1, 1, size=(12, 3))
    neg = np.concatenate([crds[scores >= 0][:10],
                          rng.uniform(2, 38, size=(5, 3))])
    return crds, diams, scores, pos, neg


def test_supervised_functions_match_jax():
    crds, diams, scores, pos, neg = _training()
    ja = JB.BlobList(crds, diams, scores)
    tb = TB.BlobList(crds, diams, scores)
    np.testing.assert_array_equal(TSUP.find_spheres(pos, crds, diams),
                                  JSUP.find_spheres(pos, crds, diams))
    rng = np.random.default_rng(26)
    s = rng.normal(size=50)
    acc = s + rng.normal(scale=0.7, size=50) < 0
    for lower in (True, False):
        assert TSUP.choose_threshold_1d(s, acc, lower) == \
            JSUP.choose_threshold_1d(s, acc, lower)
    assert TSUP.choose_threshold_interval(s, acc) == \
        JSUP.choose_threshold_interval(s, acc)
    want = JSUP.discard_blobs_by_score_supervised(ja, pos, neg)
    got = TSUP.discard_blobs_by_score_supervised(tb, pos, neg)
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0].crds, want[0].crds)
    wm = JSUP.choose_blob_score_thresholds_multi([ja, ja], [pos, pos],
                                                 [neg, neg])
    gm = TSUP.choose_blob_score_thresholds_multi([tb, tb], [pos, pos],
                                                 [neg, neg])
    assert gm == wm


def test_supervised_refuses_empty_training_sets():
    crds, diams, scores, pos, neg = _training()
    far = np.full((3, 3), 500.0)
    for p, n in ((pos, far), (far, neg)):
        with pytest.raises(ValueError, match="Empty list"):
            TSUP.choose_blob_score_thresholds(
                TB.BlobList(crds, diams, scores), p, n)


# --- the blocks of a -mesh run --------------------------------------------------

@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_sharded_blob_dog_equals_one_device(n, masked):
    """blob_dog over (2, 2) and (4, 2) CPU blocks gives the
    single-device lists bit for bit (the blocks' candidates merged into
    raster order)."""
    x, mask, _ = _phantom(seed=13, shape=(32, 40, 44))
    m = torch.tensor(mask) if masked else None
    sig = [d / (2 * np.sqrt(3.0)) for d in diameter_ladder(5.0, 10.0, 1.1)]
    one = TB.blob_dog(torch.tensor(x), sig, mask=m,
                      minima_threshold=0.0, maxima_threshold=0.0,
                      use_threshold_ratios=False)
    mesh = make_mesh(devices=["cpu"] * n)
    from visfd_tpu_torch.parallel.sharded_features import sharded_blob_dog
    got = sharded_blob_dog(torch.tensor(x), sig, mesh, mask=m,
                           minima_threshold=0.0, maxima_threshold=0.0,
                           use_threshold_ratios=False)
    for a, b in zip(got, one):
        assert len(b) > 5
        np.testing.assert_array_equal(a.crds, b.crds)
        np.testing.assert_array_equal(a.diameters, b.diameters)
        np.testing.assert_array_equal(a.scores, b.scores)
