"""The port's multi-process layer (visfd_tpu_torch/parallel/distributed.py
and the cross-rank halves of mesh, halo, gather, reduce, blocks,
extrema, the device watershed and the blob ladder) on the CPU over gloo, against the port in one process, the host
oracle and the JAX package; the port's make_membrane_step, entry points,
dry run and profiling helpers.

Two ranks run as subprocesses (``spawn_ranks``: a free port per run, a
timeout on the process group and on every child, the children killed on
failure) in two layouts: with ``devices=["cpu"] * 4`` each, the global
mesh is the (4, 2) grid of the one-process ``make_mesh(8, devices=
["cpu"] * 8)`` (rank 0 owns block rows 0-1, rank 1 rows 2-3: the ranks
meet along z); with 3 devices each, the (3, 2) grid of 6, whose middle
row is split between the ranks (they meet along y too).  Every
cross-rank result must equal the one-process result bit for bit: the
halos carry the same rows, the reductions sum integers, and the float64
mean folds the blocks in one order.  ``make_membrane_step`` against the JAX step over
``JM.make_mesh(8)``: vote atol 3e-6 and stick atol 1e-3 of the largest
vote (tests/test_parallel.py's tolerances for the XLA step).
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from visfd_tpu.parallel import mesh as JM
from visfd_tpu.parallel import reduce as JR
from visfd_tpu.parallel import sharded as JSH
from visfd_tpu_torch.cli.settings import InputError
from visfd_tpu_torch.parallel import distributed as D
from visfd_tpu_torch.parallel.gather import is_writer, to_host_np
from visfd_tpu_torch.parallel.mesh import make_mesh
from visfd_tpu_torch.parallel.sharded import make_membrane_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
CLUSTER_ENV = ("VISFD_COORDINATOR", "VISFD_NUM_PROCESSES", "VISFD_PROCESS_ID")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(code: str, args=(), n: int = 2, timeout: float = 300):
    """Run ``code`` in ``n`` fresh interpreters (cwd: the repository)
    that form one cluster through the VISFD_* variables; returns each
    rank's (stdout, stderr).  A rank that fails or outlives ``timeout``
    fails the call, and every child is killed."""
    env = dict(os.environ, VISFD_COORDINATOR=f"127.0.0.1:{free_port()}",
               VISFD_NUM_PROCESSES=str(n), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *map(str, args)],
        env=dict(env, VISFD_PROCESS_ID=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    deadline = time.monotonic() + timeout
    done = []
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            done.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (rc, _, err) in enumerate(done):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-6000:]}"
    return [(out, err) for _, out, err in done]


# --- one process ------------------------------------------------------------

def test_init_distributed_without_a_coordinator_is_a_noop(monkeypatch):
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert D.init_distributed() is False
    assert (D.process_index(), D.process_count(), D.backend()) == (0, 1, None)
    assert is_writer()


@pytest.mark.parametrize("given,missing", [
    ({"VISFD_COORDINATOR": "127.0.0.1:1"}, "VISFD_NUM_PROCESSES and "
                                           "VISFD_PROCESS_ID"),
    ({"VISFD_COORDINATOR": "127.0.0.1:1", "VISFD_NUM_PROCESSES": "2"},
     "VISFD_PROCESS_ID"),
    ({"VISFD_NUM_PROCESSES": "2", "VISFD_PROCESS_ID": "1"},
     "VISFD_COORDINATOR")])
def test_init_distributed_names_what_is_missing(monkeypatch, given, missing):
    """torch.distributed cannot detect a cluster: an incomplete one
    raises before anything is contacted."""
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in given.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(InputError, match=f"without {missing}: a "
                                         f"multi-process cluster"):
        D.init_distributed()


ONE_RANK = """
from datetime import timedelta
from visfd_tpu_torch.parallel import distributed as D
from visfd_tpu_torch.parallel.mesh import make_mesh
assert D.init_distributed(timeout=timedelta(seconds=60)) is True
assert D.init_distributed() is True          # idempotent
assert (D.process_count(), D.process_index(), D.backend()) == (1, 0, "gloo")
m = make_mesh(devices=["cpu"] * 3)
assert m.shape == (3, 1) and not m.spans_processes
assert all(m.is_local(iz, iy) for iz, iy in m.all_cells())
assert D.allreduce_sum([3, 4]).tolist() == [3, 4]
D.shutdown_distributed()
assert D.process_count() == 1
print("one-rank-ok")
"""


def test_one_process_cluster_serves_every_local_device():
    (out, _), = spawn_ranks(ONE_RANK, n=1, timeout=120)
    assert "one-rank-ok" in out


# --- two ranks --------------------------------------------------------------

# the fields and the results both sides compute: run by the ranks and,
# for the one-process reference, here (``exec``), so one definition serves
COMMON = """
import numpy as np
import torch
from visfd_tpu_torch.features.blob import blob_dog
from visfd_tpu_torch.parallel import halo as H
from visfd_tpu_torch.parallel import reduce as TR
from visfd_tpu_torch.parallel.gather import to_host_np
from visfd_tpu_torch.parallel.mesh import gather_flat, shard
from visfd_tpu_torch.parallel.sharded import make_membrane_step
from visfd_tpu_torch.segment.extrema import find_extrema
from visfd_tpu_torch.segment.propagate import propagate_watershed

SCORE_SHAPE = (12, 12, 9)       # blocks (3, 6) on (4, 2), (4, 6) on (3, 2)
HALO_SHAPE = (2, 12, 6, 5)      # blocks (3, 3) and (4, 3)
HALO_CASES = [(1, 1), (4, 2), (7, 4)]  # up to 3 blocks deep
FRACTIONS = (0.0, 0.05, 0.5, 1.0)
FLAT = np.random.default_rng(8).permutation(int(np.prod(SCORE_SHAPE)))[:300]
SIGMAS = (0.8, 1.0, 1.25, 1.5)


def _fields():
    rng = np.random.default_rng(7)
    score = rng.normal(size=SCORE_SHAPE).astype(np.float32)
    score[0, :5] = 0.5                       # duplicates
    mask = (rng.uniform(size=SCORE_SHAPE) > 0.4).astype(np.float32)
    a = rng.normal(size=HALO_SHAPE).astype(np.float32)
    plateaus = np.round(rng.normal(size=SCORE_SHAPE) * 1.5).astype(
        np.float32)
    return score, mask, a, plateaus


def _blob_field():
    # Gaussian blobs of both signs, over several blocks, on noise
    z, y, x = np.indices(SCORE_SHAPE)
    f = 0.05 * np.random.default_rng(9).normal(size=SCORE_SHAPE)
    for k, c in enumerate([(3, 3, 4), (6, 6, 4), (8, 9, 3), (4, 9, 5),
                           (9, 3, 5), (6, 2, 2)]):
        r2 = (z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2
        f += (-1) ** k * np.exp(-r2 / (2 * 1.1 ** 2))
    return f.astype(np.float32)


def _results(mesh, fields):
    '''Everything the two-rank test compares, as {name: array}; haloed
    and per-cell results only for the cells this process holds.'''
    score, mask, a, plateaus = fields
    res = {}
    s_vol, m_vol = shard(score, mesh), shard(mask, mesh)
    res["gather"] = to_host_np(shard(a, mesh, lead=1))
    res["thr"] = np.array([TR.fraction_threshold(s_vol, f) for f in FRACTIONS])
    res["thr_masked"] = np.array([TR.fraction_threshold(s_vol, f, mask=m_vol)
                                  for f in FRACTIONS])
    res["count"] = np.array([TR.count_valid(s_vol, m_vol)])
    res["kth"] = np.array([TR.kth_largest(s_vol, k) for k in (0, 7, 500)])
    res["stats"] = np.array(TR.global_min_max_mean(s_vol))
    res["stats_masked"] = np.array(TR.global_min_max_mean(s_vol, m_vol))
    for hz, hy in HALO_CASES:
        for lead, arr in ((0, a[0]), (1, a)):
            vol = H.halo_pad_2d(shard(arr, mesh, lead=lead), hz, hy)
            for iz, iy, b in vol.cells():
                res[f"halo_{hz}_{hy}_{lead}_{iz}_{iy}"] = b.numpy()
    vol = shard(a[0], mesh)
    ghosted = H.with_ghosts(vol, 3, 4)
    bz, by = vol.block_shape
    for iz, iy, _ in vol.cells():
        for k, t in enumerate(H.face_halos(H.with_ghosts(vol, 1, 1), iz, iy)):
            res[f"face_{k}_{iz}_{iy}"] = t.numpy()
        res[f"window_{iz}_{iy}"] = H.window(
            ghosted, iz * bz - 3, (iz + 1) * bz + 2, iy * by - 4,
            (iy + 1) * by + 1, 7.0, "cpu").numpy()
    for name, x in (("extrema", score), ("plateaus", plateaus)):
        r = find_extrema(shard(x, mesh), mask=m_vol, connectivity=1)
        for k in ("minima_indices", "minima_scores", "minima_nvoxels",
                  "maxima_indices", "maxima_scores", "maxima_nvoxels"):
            res[f"{name}_{k}"] = np.asarray(getattr(r, k))
    step, shard_input = make_membrane_step(mesh, sigma=1.0, tv_sigma=1.0,
                                           saliency_threshold=0.02)
    stick, vote = step(shard_input(score))
    res["step_stick"], res["step_vote"] = to_host_np(stick), to_host_np(vote)
    res["gather_flat"] = gather_flat(s_vol, FLAT)
    res["gather_flat_int"] = gather_flat(shard(plateaus, mesh).with_blocks(
        lambda iz, iy, b: b.to(torch.int64)), FLAT)
    markers = np.zeros(SCORE_SHAPE, np.int64)
    markers.reshape(-1)[FLAT[:6]] = [3, 1, 4, 1, 5, 9]
    for name, kw in (("ws", dict(mask=m_vol)),
                     ("ws_plateaus", dict(source=shard(plateaus, mesh),
                                          connectivity=3)),
                     ("ws_markers", dict(markers=markers,
                                         start_from_minima=False,
                                         halt_threshold=1.0))):
        r = propagate_watershed(**{"source": s_vol, "show_boundaries": True,
                                   **kw})
        res[name + "_labels"] = to_host_np(r.labels)
        res[name + "_locations"] = r.basin_locations
        res[name + "_scores"] = r.basin_scores
    for kind, bl in zip(("min", "max"), blob_dog(
            shard(_blob_field(), mesh), SIGMAS,
            use_threshold_ratios=False)):
        res[f"blob_{kind}_crds"] = bl.crds
        res[f"blob_{kind}_sigmas"] = bl.diameters
        res[f"blob_{kind}_scores"] = bl.scores
    return res
"""
_COMMON = {}
exec(COMMON, _COMMON)
SCORE_SHAPE, FRACTIONS, HALO_CASES, FLAT = (_COMMON[k] for k in (
    "SCORE_SHAPE", "FRACTIONS", "HALO_CASES", "FLAT"))
_fields, _results = _COMMON["_fields"], _COMMON["_results"]


TWO_RANKS = COMMON + """
import json, sys
from datetime import timedelta
import torch
torch.set_num_threads(2)
from visfd_tpu_torch.parallel import distributed as D
from visfd_tpu_torch.parallel.gather import is_writer
from visfd_tpu_torch.parallel.mesh import make_mesh
assert D.init_distributed(backend="gloo", timeout=timedelta(seconds=90))
rank = D.process_index()
assert D.process_count() == 2 and is_writer() == (rank == 0)
per_rank = int(sys.argv[2])
mesh = make_mesh(2 * per_rank, devices=["cpu"] * per_rank)
res = _results(mesh, _fields())
res["ranks"] = np.array(mesh.ranks)
np.savez(f"{sys.argv[1]}/rank{rank}.npz", **res)
json.dump(D.traffic, open(f"{sys.argv[1]}/traffic{rank}.json", "w"))
D.shutdown_distributed()
print(f"rank{rank}-ok")
"""


# devices a rank -> each cell's owner on the global grid
LAYOUTS = {4: [[0, 0], [0, 0], [1, 1], [1, 1]], 3: [[0, 0], [0, 1], [1, 1]]}


@pytest.fixture(scope="module", params=list(LAYOUTS),
                ids=lambda n: f"{n}_devices_a_rank")
def layout(request):
    return request.param


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, layout):
    d = tmp_path_factory.mktemp("two_ranks")
    outs = spawn_ranks(TWO_RANKS, [d, layout], timeout=300)
    assert [f"rank{r}-ok" in o for r, (o, _) in enumerate(outs)] == [True] * 2
    return ([dict(np.load(d / f"rank{r}.npz")) for r in range(2)],
            [json.load(open(d / f"traffic{r}.json")) for r in range(2)])


@pytest.fixture(scope="module")
def one_process(layout):
    return _results(make_mesh(2 * layout, devices=["cpu"] * (2 * layout)),
                    _fields())


def test_two_ranks_share_the_grid(two_ranks, layout):
    ranks, traffic = two_ranks
    for r in range(2):
        assert ranks[r]["ranks"].tolist() == LAYOUTS[layout]
        assert traffic[r]["halo"]["bytes_received"] > 0
        assert traffic[r]["gather"]["bytes_received"] > 0


def test_two_ranks_to_host_np_whole_on_every_rank(two_ranks):
    a = _fields()[2]
    for res in two_ranks[0]:
        np.testing.assert_array_equal(res["gather"], a)


@pytest.mark.parametrize("masked", [False, True])
def test_two_ranks_fraction_threshold_exact(two_ranks, one_process, masked):
    """Equal on both ranks to one process, the host order statistic and
    the JAX package's radix selection over its 8-device mesh."""
    score, mask = _fields()[:2]
    key = "thr_masked" if masked else "thr"
    vals = score[mask != 0] if masked else score.ravel()
    jmesh = JM.make_mesh(8)
    for i, f in enumerate(FRACTIONS):
        k = min(int(np.floor(vals.size * f)), vals.size - 1)
        want = np.sort(vals)[::-1][k]
        jax_thr = JR.fraction_threshold(score, f, mesh=jmesh,
                                        mask=mask if masked else None)
        for res in two_ranks[0]:
            assert res[key][i] == one_process[key][i] == want == jax_thr


def test_two_ranks_kth_largest_and_count(two_ranks, one_process):
    score, mask = _fields()[:2]
    desc = np.sort(score.ravel())[::-1]
    for res in two_ranks[0]:
        assert res["kth"].tolist() == [desc[0], desc[7], desc[500]]
        assert res["count"][0] == int((mask != 0).sum()) == \
            one_process["count"][0]


@pytest.mark.parametrize("key", ["stats", "stats_masked"])
def test_two_ranks_global_min_max_mean(two_ranks, one_process, key):
    """Bit for bit the one-process fold; min and max the oracle's."""
    score, mask = _fields()[:2]
    vals = score[mask != 0] if key == "stats_masked" else score.ravel()
    for res in two_ranks[0]:
        np.testing.assert_array_equal(res[key], one_process[key])
        assert res[key][:2].tolist() == [vals.min(), vals.max()]
        assert res[key][2] == pytest.approx(vals.astype(np.float64).mean(),
                                            rel=1e-12)


def _per_cell(two_ranks, prefix):
    got = {}
    for res in two_ranks[0]:
        got.update({k: v for k, v in res.items() if k.startswith(prefix)})
    return got


@pytest.mark.parametrize("hz,hy", HALO_CASES)
def test_two_ranks_halo_pad_2d(two_ranks, one_process, layout, hz, hy):
    """Every block of both ranks, plain and channel-major, equals the
    one-process haloed block (halos up to 3 blocks deep, corners
    included)."""
    got = _per_cell(two_ranks, f"halo_{hz}_{hy}_")
    want = {k: v for k, v in one_process.items()
            if k.startswith(f"halo_{hz}_{hy}_")}
    assert sorted(got) == sorted(want) and len(got) == 2 * 2 * layout
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("prefix", ["face_", "window_"])
def test_two_ranks_face_halos_and_window(two_ranks, one_process, prefix):
    got = _per_cell(two_ranks, prefix)
    want = {k: v for k, v in one_process.items() if k.startswith(prefix)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", ["extrema", "plateaus"])
def test_two_ranks_find_extrema(two_ranks, one_process, name):
    """The -connect seeds' function over blocks of both ranks: the fast
    path and (integer values) the plateau-heavy propagation."""
    for res in two_ranks[0]:
        for k in [k for k in one_process if k.startswith(name + "_")]:
            np.testing.assert_array_equal(res[k], one_process[k])
    assert len(one_process[f"{name}_maxima_indices"]) > 0


def test_two_ranks_membrane_step(two_ranks, one_process):
    for res in two_ranks[0]:
        for k in ("step_stick", "step_vote"):
            np.testing.assert_array_equal(res[k], one_process[k])


@pytest.mark.parametrize("key", ["gather_flat", "gather_flat_int"])
def test_two_ranks_gather_flat(two_ranks, one_process, key):
    """Each index's value from the rank that owns its block, on every
    rank: the host array's."""
    score, _, _, plateaus = _fields()
    field = score if key == "gather_flat" else plateaus.astype(np.int64)
    for res in two_ranks[0]:
        np.testing.assert_array_equal(res[key], one_process[key])
        np.testing.assert_array_equal(res[key], field.reshape(-1)[FLAT])


@pytest.mark.parametrize("name", ["ws", "ws_plateaus", "ws_markers"])
def test_two_ranks_propagate_watershed(two_ranks, one_process, name):
    """The device watershed with Meyer boundaries over blocks of both
    ranks: a mask, integer plateaus (26-connected), markers on the
    maxima with a halt: labels, basin locations and scores."""
    keys = [f"{name}_{k}" for k in ("labels", "locations", "scores")]
    assert one_process[name + "_labels"].max() > 3
    for res in two_ranks[0]:
        for k in keys:
            np.testing.assert_array_equal(res[k], one_process[k])


def test_two_ranks_blob_dog(two_ranks, one_process):
    """blob_dog over blocks of both ranks: each scale's candidates
    all-gathered and merged on their raster index."""
    keys = [f"blob_{kind}_{k}" for kind in ("min", "max")
            for k in ("crds", "sigmas", "scores")]
    assert min(len(one_process[f"blob_{kind}_scores"])
               for kind in ("min", "max")) >= 2
    for res in two_ranks[0]:
        for k in keys:
            np.testing.assert_array_equal(res[k], one_process[k])


# --- make_membrane_step, the entry points, profiling -----------------------

def test_make_membrane_step_matches_jax():
    x = np.random.default_rng(11).normal(size=(16, 24, 20)).astype(
        np.float32)
    jmesh = JM.make_mesh(8)
    jstep, sharding = JSH.make_membrane_step(
        jmesh, sigma=1.5, tv_sigma=1.5, tv_exponent=4,
        saliency_threshold=0.01)
    jstick, jvote = jstep(jax.device_put(jnp.asarray(x), sharding))
    step, shard_input = make_membrane_step(
        make_mesh(8, devices=["cpu"] * 8), sigma=1.5, tv_sigma=1.5,
        tv_exponent=4, saliency_threshold=0.01)
    stick, vote = step(shard_input(x))
    jvote = np.asarray(jvote)
    scale = float(np.abs(jvote).max())
    np.testing.assert_allclose(np.moveaxis(to_host_np(vote), 0, -1), jvote,
                               atol=3e-6 * scale)
    np.testing.assert_allclose(to_host_np(stick), np.asarray(jstick),
                               atol=1e-3 * scale)


def test_entry_forward_matches_jax():
    import __graft_entry__ as G
    jfwd, jargs = G.entry()
    want = np.asarray(jfwd(*jargs))
    from visfd_tpu_torch.entry import entry
    fwd, args = entry(device="cpu")
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    got = fwd(*args).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


def test_dryrun_multichip_on_cpu_blocks():
    from visfd_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(8, devices=["cpu"] * 8)


def test_device_trace_writes_a_trace(tmp_path):
    from visfd_tpu_torch.utils.profiling import device_trace
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    events = json.load(open(prof.trace_path))["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)

