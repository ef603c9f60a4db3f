"""The port's watershed (segment/watershed: the host Meyer flood;
segment/propagate: the device label propagation) against the JAX
package's, on the CPU.

The same seeded numpy inputs go through ``visfd_tpu.segment`` (XLA on
the CPU) and ``visfd_tpu_torch.segment`` (torch on the CPU): smooth
random fields (minima and maxima, connectivity 1 and 3, a mask, halt
thresholds, markers) and plateau-heavy integer-valued ones.  Labels,
basin locations and scores must be equal; the native flood must equal
its Python twin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visfd_tpu.segment import extrema as JE
from visfd_tpu.segment import propagate as JP
from visfd_tpu.segment import watershed as JW
from visfd_tpu_torch.parallel.blocks import check_index_width, fixpoint
from visfd_tpu_torch.segment import extrema as TE
from visfd_tpu_torch.segment import propagate as TP
from visfd_tpu_torch.segment import watershed as TW

SHAPE = (12, 13, 15)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _field(kind, seed=5, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    for ax in range(3):
        x = (x + np.roll(x, 1, ax) + np.roll(x, -1, ax)) / 3.0
    if kind == "integers":     # plateau-heavy
        x = np.round(x * 4)
    elif kind == "distinct":   # no ties: the Meyer-exact regime
        x = x.astype(np.float64) + np.arange(x.size).reshape(shape) * 1e-9
    return x.astype(np.float32)


def _mask(seed=1, shape=SHAPE):
    return (np.random.default_rng(seed).random(shape) > 0.12).astype(
        np.float32)


def _markers(seed=2, shape=SHAPE):
    rng = np.random.default_rng(seed)
    m = rng.integers(1, 6, size=shape) * (rng.random(shape) > 0.985)
    return m.astype(np.int64)


def _same(t, j):
    np.testing.assert_array_equal(np.asarray(t.labels), np.asarray(j.labels))
    assert t.num_basins == j.num_basins
    np.testing.assert_array_equal(t.basin_locations, j.basin_locations)
    np.testing.assert_array_equal(t.basin_scores, j.basin_scores)


CASES = {
    # name: (field, keyword arguments)
    "minima": ("smooth", dict()),
    "maxima": ("smooth", dict(start_from_minima=False)),
    "conn3-mask": ("smooth", dict(connectivity=3, mask=True)),
    "halt": ("smooth", dict(halt_threshold=0.05)),
    "maxima-halt": ("smooth", dict(start_from_minima=False,
                                   halt_threshold=-0.05)),
    "markers": ("smooth", dict(markers=True, mask=True)),
    "integers": ("integers", dict()),
    "integers-maxima-conn3": ("integers", dict(start_from_minima=False,
                                               connectivity=3)),
    "labels": ("smooth", dict(label_boundary=99, label_undefined=-7,
                              halt_threshold=0.1, mask=True)),
}


def _kw(kw):
    kw = dict(kw)
    if kw.pop("mask", False):
        kw["mask"] = _mask()
    if kw.pop("markers", False):
        kw["markers"] = _markers()
    return kw


@pytest.mark.parametrize("boundaries", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_watershed_matches_jax(case, boundaries):
    field, kw = CASES[case]
    x, kw = _field(field), _kw(kw)
    want = JW.watershed(x, show_boundaries=boundaries, **kw)
    got = TW.watershed(torch.tensor(x), show_boundaries=boundaries, **kw)
    _same(got, want)


@pytest.mark.parametrize("boundaries", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_propagate_watershed_matches_jax(case, boundaries):
    field, kw = CASES[case]
    x, kw = _field(field), _kw(kw)
    want = JP.propagate_watershed(x, show_boundaries=boundaries, **kw)
    got = TP.propagate_watershed(torch.tensor(x), show_boundaries=boundaries,
                                 **kw)
    _same(got, want)


@pytest.mark.parametrize("minima", [True, False])
def test_propagate_equals_meyer_on_distinct_values(minima):
    """Where intensities are distinct, the device watershed gives the
    host flood's labels, boundaries included (the JAX test_propagate.py
    standard)."""
    x = _field("distinct", seed=11)
    for sb in (False, True):
        host = TW.watershed(x, start_from_minima=minima, show_boundaries=sb)
        dev = TP.propagate_watershed(x, start_from_minima=minima,
                                     show_boundaries=sb)
        np.testing.assert_array_equal(dev.labels.numpy(), host.labels)


@pytest.mark.parametrize("field", ["smooth", "integers"])
def test_descend_and_postprocess_match_jax(field):
    x, mask = _field(field), _mask()
    offs = JE.neighbor_offsets(1)
    root_j, valid_j = JP._descend_device(jnp.asarray(x), jnp.asarray(mask),
                                         offs)
    root_t, valid_t = TP._descend_device(torch.tensor(x), torch.tensor(mask),
                                         offs)
    np.testing.assert_array_equal(root_t.numpy(), np.asarray(root_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    for halt in (np.inf, 0.1):
        want = JP.postprocess_basins(np.asarray(root_j), np.asarray(valid_j),
                                     x, True, halt, -1)
        got = TP.postprocess_basins(root_t, valid_t, torch.tensor(x), True,
                                    halt, -1)
        _same(got, want)


@pytest.mark.parametrize("conn", [1, 3])
def test_minimax_and_meyer_boundaries_match_jax(conn):
    x = _field("smooth", seed=8)
    offs = JE.neighbor_offsets(conn)
    res = JP.propagate_watershed(x, connectivity=conn)
    seeds = np.zeros(x.shape, np.int32)
    locs = res.basin_locations
    seeds[locs[:, 2], locs[:, 1], locs[:, 0]] = np.arange(1, len(locs) + 1)
    mask = _mask(3)
    r_j, l_j = JP._minimax_device(jnp.asarray(x), jnp.asarray(seeds),
                                  jnp.asarray(mask), offs)
    r_t, l_t = TP._minimax_device(torch.tensor(x), torch.tensor(seeds),
                                  torch.tensor(mask), offs)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    want = JP.meyer_boundaries(res.labels, np.asarray(r_j), x, offs,
                               valid=mask, label_boundary=-3)
    got = TP.meyer_boundaries(torch.tensor(res.labels), r_t, torch.tensor(x),
                              offs, valid=torch.tensor(mask),
                              label_boundary=-3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_meyer_boundaries_dense_contest_matches_jax():
    """Random labels and keys: nearly every voxel contested, long
    dependency chains (the vectorised rounds and the sequential tail)."""
    rng = np.random.default_rng(9)
    shape = (10, 11, 12)
    labels = rng.integers(1, 5, size=shape).astype(np.int64)
    r = np.round(rng.random(shape) * 3).astype(np.float32)   # equal keys
    x = rng.permutation(int(np.prod(shape))).astype(np.float32).reshape(
        shape)
    offs = JE.neighbor_offsets(1)
    want = JP.meyer_boundaries(labels, r, x, offs, label_boundary=0)
    got = TP.meyer_boundaries(torch.tensor(labels), torch.tensor(r),
                              torch.tensor(x), offs, label_boundary=0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("minima", [True, False])
def test_marker_watershed_matches_jax(minima):
    x, mask, markers = _field("smooth", seed=4), _mask(5), _markers(6)
    x_s = x if minima else -x
    offs = JE.neighbor_offsets(1)
    for halt in (np.inf, 0.05):
        want = JP._marker_watershed(jnp.asarray(x_s), jnp.asarray(mask),
                                    markers, offs, minima, halt, -1)
        got = TP._marker_watershed(torch.tensor(x_s), torch.tensor(mask),
                                   markers, offs, minima, halt, -1)
        _same(got, want)


@pytest.mark.parametrize("boundaries", [False, True])
@pytest.mark.parametrize("field", ["smooth", "integers"])
def test_native_flood_equals_python_twin(field, boundaries):
    x, mask = _field(field), _mask() != 0
    res = TE.find_extrema(torch.tensor(x), mask=torch.tensor(mask),
                          find_maxima=False, connectivity=1,
                          want_label_image=False)
    locs = [TE.flat_to_xyz(int(i), x.shape) for i in res.minima_indices]
    got = TW.watershed(x, mask=mask, show_boundaries=boundaries)
    want = TW._flood_python(x, mask, locs, res.minima_scores, len(locs),
                            TE.neighbor_offsets(1), 1.0, np.inf, boundaries)
    np.testing.assert_array_equal(got.labels, want)


def test_fixpoint_stops_at_the_cap():
    """A loop that never settles runs exactly max_it iterations, however
    many the flag is read after; one that settles reports the changing
    iterations plus the one that found the fixpoint."""
    def step(n):
        return n + 1, [torch.tensor(True)]
    for cap in (1, 7, 8, 13, 30):
        assert fixpoint(step, 0, cap) == (cap, cap)

    def settles(n):
        new = min(n + 1, 11)
        return new, [torch.tensor(new != n)]
    assert fixpoint(settles, 0) == (11, 12)
    assert fixpoint(settles, 0, 12) == (11, 12)
    assert fixpoint(settles, 0, 5) == (5, 5)


def test_index_width_is_checked():
    check_index_width((1024, 1024, 1024))
    with pytest.raises(ValueError, match="int32"):
        check_index_width((2048, 1024, 1024))
