"""The port's sharded segmentation (parallel/sharded_features and the
mesh branch of segment/connect.label_connected) against the port on one
device and against the JAX package's sharded functions.

JAX runs on the 8 host devices tests/conftest.py forces, as a (4, 2)
mesh; the port builds the same (4, 2) mesh of CPU blocks with
``make_mesh(8, devices=["cpu"] * 8)``, and a (2, 2) and an (8, 1) one
whose blocks are 2 voxels thick.  Every list, label and gate must be
equal; the sharded FD gradient and the haloed blocks equal the
single-device ones bit for bit.
"""

import numpy as np
import pytest
import torch

from visfd_tpu.parallel import mesh as JM
from visfd_tpu.parallel import sharded_features as JSF
from visfd_tpu.segment import extrema as JE
from visfd_tpu_torch.features.hessian import gradient_fd
from visfd_tpu_torch.linalg import sym3
from visfd_tpu_torch.ops.filters import apply_gauss
from visfd_tpu_torch.parallel import sharded_features as TSF
from visfd_tpu_torch.parallel.gather import to_host_np
from visfd_tpu_torch.parallel.halo import haloed_block
from visfd_tpu_torch.parallel.mesh import Mesh, make_mesh, shard
from visfd_tpu_torch.parallel.sharded import gradient_sharded
from visfd_tpu_torch.segment import connect as TC
from visfd_tpu_torch.segment import extrema as TE
from visfd_tpu_torch.segment import propagate as TP

SHAPE = (16, 14, 13)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jmesh():
    return JM.make_mesh(8)


MESHES = ["4x2", "2x2", "8x1"]


def _tmesh(name):
    if name == "8x1":        # 8 blocks of 2 z planes
        return Mesh(tuple((torch.device("cpu"),) for _ in range(8)))
    n = {"4x2": 8, "2x2": 4}[name]
    return make_mesh(n, devices=["cpu"] * n)


def _field(kind, seed=5, shape=SHAPE):
    x = torch.tensor(np.random.default_rng(seed).normal(size=shape)
                     .astype(np.float32))
    x = apply_gauss(x, 1.2).numpy()
    if kind == "integers":
        x = np.round(x * 8)
    elif kind == "plateaus":
        x = np.round(x * 40) / 40
    return x.astype(np.float32)


def _mask(seed=1, shape=SHAPE):
    return (np.random.default_rng(seed).random(shape) > 0.1).astype(
        np.float32)


EXTREMA_KW = {
    "conn1": dict(connectivity=1),
    "conn3-no-borders": dict(connectivity=3, allow_borders=False),
    "thresholds": dict(connectivity=2, minima_threshold=-0.05,
                       maxima_threshold=0.05),
    "maxima-only": dict(connectivity=1, find_minima=False),
}
FIELDS = ["smooth", "plateaus", "integers"]
EXTREMA_FIELDS = ("minima_indices", "minima_scores", "minima_nvoxels",
                  "maxima_indices", "maxima_scores", "maxima_nvoxels",
                  "label_image")


@pytest.mark.parametrize("masked", [False, True], ids=["", "masked"])
@pytest.mark.parametrize("kw", list(EXTREMA_KW))
@pytest.mark.parametrize("field", FIELDS)
def test_find_extrema_sharded(jmesh, field, kw, masked):
    x = _field(field)
    mask = _mask() if masked else None
    kw = EXTREMA_KW[kw]
    want = TE.find_extrema(torch.tensor(x), mask=None if mask is None
                           else torch.tensor(mask), **kw)
    jax_ = JSF.find_extrema_sharded(x, jmesh, mask=mask, **kw)
    for name in ("4x2", "8x1"):
        got = TSF.find_extrema_sharded(x, _tmesh(name), mask=mask, **kw)
        for f in EXTREMA_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in EXTREMA_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jax_, f)),
                                      getattr(want, f))


@pytest.mark.parametrize("conn", [1, 3])
def test_sharded_minimax(jmesh, conn):
    x, mask = _field("smooth", seed=8), _mask(2)
    seeds = np.zeros(SHAPE, np.int32)
    rng = np.random.default_rng(3)
    flat = rng.choice(x.size, 9, replace=False)
    seeds.reshape(-1)[flat] = np.arange(1, 10)
    offs = TE.neighbor_offsets(conn)
    r1, l1 = TP._minimax_device(torch.tensor(x), torch.tensor(seeds),
                                torch.tensor(mask), offs)
    for name in MESHES:
        r, lab = TSF.sharded_minimax(x, seeds, mask, offs, _tmesh(name))
        np.testing.assert_array_equal(r, r1.numpy())
        np.testing.assert_array_equal(lab, l1.numpy())
    r_j, l_j = JSF.sharded_minimax(x, seeds, mask, JE.neighbor_offsets(conn),
                                   jmesh)
    np.testing.assert_array_equal(r_j, r1.numpy())
    np.testing.assert_array_equal(l_j, l1.numpy())


WS_CASES = {
    "minima": ("smooth", dict()),
    "maxima-boundaries": ("smooth", dict(start_from_minima=False,
                                         show_boundaries=True)),
    "mask-conn3-halt": ("smooth", dict(connectivity=3, mask=True,
                                       halt_threshold=0.05)),
    "markers-boundaries": ("smooth", dict(markers=True, mask=True,
                                          show_boundaries=True)),
    "integers-boundaries": ("integers", dict(show_boundaries=True)),
}


@pytest.mark.parametrize("case", list(WS_CASES))
def test_propagate_watershed_sharded(jmesh, case):
    field, kw = WS_CASES[case]
    kw = dict(kw)
    x = _field(field, seed=6)
    if kw.pop("mask", False):
        kw["mask"] = _mask(4)
    if kw.pop("markers", False):
        rng = np.random.default_rng(7)
        kw["markers"] = (rng.integers(1, 5, size=SHAPE)
                         * (rng.random(SHAPE) > 0.98)).astype(np.int64)
    single = TP.propagate_watershed(x, **kw)
    for name in MESHES:
        got = TSF.propagate_watershed_sharded(x, _tmesh(name), **kw)
        np.testing.assert_array_equal(to_host_np(got.labels),
                                      single.labels.numpy())
        assert got.num_basins == single.num_basins
        np.testing.assert_array_equal(got.basin_locations,
                                      single.basin_locations)
        np.testing.assert_array_equal(got.basin_scores, single.basin_scores)
    want = JSF.propagate_watershed_sharded(x, jmesh, **kw)
    np.testing.assert_array_equal(single.labels.numpy(), want.labels)


@pytest.fixture(scope="module")
def connect_fields():
    rng = np.random.default_rng(5)
    sal = _field("smooth", seed=5)
    t6 = rng.normal(size=(6,) + SHAPE).astype(np.float32)
    v3 = rng.normal(size=(3,) + SHAPE).astype(np.float32)
    return sal, t6, v3, _mask(9)


GATE_KW = dict(threshold_tensor=0.3, threshold_vector=0.2,
               order=sym3.EigenOrder.DECREASING)


@pytest.mark.parametrize("consider_sign", [False, True])
def test_discard_gates_sharded(connect_fields, consider_sign):
    sal, t6, v3, _ = connect_fields
    want = TC.discard_gates(torch.tensor(sal), torch.tensor(t6),
                            torch.tensor(v3), consider_sign=consider_sign,
                            neg_hess=True, **GATE_KW)
    for name in MESHES:
        mesh = _tmesh(name)
        got = TC.discard_gates(shard(sal, mesh), shard(t6, mesh, lead=1),
                               shard(v3, mesh, lead=1),
                               consider_sign=consider_sign, neg_hess=True,
                               slab_voxels=64, **GATE_KW)
        np.testing.assert_array_equal(to_host_np(got), want.numpy())


def test_connect_candidates_sharded(connect_fields):
    """The -connect candidate lists compacted per block and merged equal
    the single-device lists."""
    sal, t6, v3, mask = connect_fields
    thr = float(np.percentile(sal, 70))
    disc = TC.discard_gates(torch.tensor(sal), torch.tensor(t6),
                            torch.tensor(v3), consider_sign=False,
                            neg_hess=True, **GATE_KW)
    want = TC.compact_candidates(torch.tensor(sal), disc, torch.tensor(mask),
                                 torch.tensor(t6), torch.tensor(v3), thr,
                                 -1.0)
    for name in MESHES:
        mesh = _tmesh(name)
        got = TC._candidates_sharded(
            shard(sal, mesh), shard(disc.float().numpy(), mesh).with_blocks(
                lambda iz, iy, b: b != 0), shard(mask, mesh),
            shard(t6, mesh, lead=1), shard(v3, mesh, lead=1), thr, -1.0,
            TC.Report(None))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


CONNECT_KW = {
    "plain": dict(),
    "gates-unsigned": dict(
        gates=True, threshold_tensor_saliency=0.3,
        threshold_vector_saliency=0.2, threshold_tensor_neighbor=0.1,
        threshold_vector_neighbor=0.4, consider_dot_product_sign=False,
        standardize_vector_sign=True),
    "minima-gates-signed": dict(
        gates=True, start_from_saliency_maxima=False,
        threshold_tensor_saliency=0.2, threshold_vector_saliency=0.1,
        threshold_tensor_neighbor=-0.2, consider_dot_product_sign=True),
}


@pytest.mark.parametrize("masked", [False, True], ids=["", "masked"])
@pytest.mark.parametrize("case", list(CONNECT_KW))
def test_label_connected_sharded(connect_fields, case, masked):
    """The mesh branch: gates, seeds (find_extrema_sharded) and
    compaction per block, the same native flood: the single-device
    labels, cluster statistics and standardized vectors."""
    sal, t6, v3, mask = connect_fields
    kw = dict(CONNECT_KW[case])
    gates = kw.pop("gates", False)
    kw["threshold_saliency"] = float(np.percentile(
        sal, 60 if kw.get("start_from_saliency_maxima", True) else 40))
    m = mask if masked else None
    want = TC.label_connected(
        torch.tensor(sal), mask=None if m is None else torch.tensor(m),
        tensor=torch.tensor(t6) if gates else None,
        vector=torch.tensor(v3) if gates else None, **kw)
    mesh = _tmesh("4x2")
    got = TC.label_connected(
        shard(sal, mesh), mask=None if m is None else shard(m, mesh),
        tensor=shard(t6, mesh, lead=1) if gates else None,
        vector=shard(v3, mesh, lead=1) if gates else None, **kw)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.num_clusters == want.num_clusters > 0
    np.testing.assert_array_equal(got.cluster_sizes, want.cluster_sizes)
    np.testing.assert_array_equal(got.cluster_maxima, want.cluster_maxima)
    if want.vector_standardized is not None:
        np.testing.assert_array_equal(got.vector_standardized,
                                      want.vector_standardized)


def test_gradient_sharded_equals_single():
    x = _field("smooth", seed=2)
    want = gradient_fd(torch.tensor(x)).movedim(-1, 0).numpy()
    for name in MESHES:
        got = gradient_sharded(shard(x, _tmesh(name)))
        np.testing.assert_array_equal(to_host_np(got), want)


@pytest.mark.parametrize("halo", [1, 2, 5])
def test_haloed_block(halo):
    """A block with halos deeper than the blocks: its neighbours' rows
    from as many blocks away as needed, the fill beyond the volume."""
    x = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    mesh = _tmesh("8x1")
    vol = shard(x, mesh)
    p = np.pad(x, ((halo, halo), (halo, halo), (0, 0)),
               constant_values=-1.0)
    bz, by = vol.block_shape
    for iz, iy, _ in vol.cells():
        got = haloed_block(vol, iz, iy, halo, fill=-1.0)
        want = p[iz * bz:(iz + 1) * bz + 2 * halo,
                 iy * by:(iy + 1) * by + 2 * halo]
        np.testing.assert_array_equal(got.numpy(), want)
