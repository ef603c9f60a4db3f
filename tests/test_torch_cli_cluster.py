"""filter_mrc -mesh in a two-process cluster on the CPU over gloo.

Two ranks (subprocesses through ``spawn_ranks`` of
``tests/test_torch_distributed.py``) each run ``run(argv, device="cpu",
mesh_devices=["cpu"] * 4)`` on ``tests/test_torch_cli.py``'s phantom,
(Z, Y, X) = (20, 28, 40): the global grid is the (4, 2) of the
one-process ``-mesh 8`` over ``["cpu"] * 8``, blocks (5, 14).  The
commands: the flagship (with ``-connect``, ``-normals-file``,
``-save/-load-progress``, ``-cl``), ``-edge``, the stand-alone
``-connect``, the separable, dense and median filters, morphology,
``-template-gauss``, ``-doggxy``, and a volume the grid does not divide
(run whole on every rank).  For each:

* rank 0 writes every file and prints ``writing tomogram``; rank 1
  writes nothing and prints ``skipping tomogram write``;
* the tomogram (and the PLY, the saved vote channels) equals the
  one-process ``-mesh 8`` run's bit for bit;
* the flagship, with and without ``-connect``, agrees with the JAX CLI's
  ``-mesh 8`` run (its Pallas kernels in interpret mode): the score to
  rtol 2e-4 / atol 2e-5 of the largest (the TV tolerance), the labels
  equal (as ``tests/test_torch_cli_connect.py`` holds them).

Each command runs once in the two ranks, the ranks meeting at a barrier
after it (``-load-progress`` reads what rank 0 wrote); a failure is
recorded per command.  The handlers -mesh does not run in a cluster
raise ``InputError`` naming their flag before the cluster is joined.
"""

import json

import numpy as np
import pytest
import torch

from visfd_tpu.cli import filter_mrc as JFM
from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.cli.settings import InputError
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.utils.phantom import membrane_phantom
from visfd_tpu_torch.utils.progress import Report

from test_torch_distributed import spawn_ranks

SHAPE = (20, 28, 40)
MEMBRANE = "-w 1 -membrane minima 2.5 -tv 1.0 -tv-angle-exponent 4"
CASES = {
    "membrane": MEMBRANE,
    "connect": MEMBRANE + " -connect {thr} -connect-angle 30 "
                          "-select-cluster 1 -normals-file {out}.ply",
    "save": MEMBRANE + " -save-progress {out}",
    "load": MEMBRANE + " -load-progress {d}/save_{tag} -connect {thr} "
                       "-connect-angle 30",
    "intensity": MEMBRANE + " -cl -1 1.5",
    "edge": "-w 1 -edge minima 1.5 -tv 1.0 -tv-angle-exponent 4",
    "gauss": "-w 1 -gauss 2",
    "gauss_mask": "-w 1 -gauss 2 -mask {d}/mask.mrc",
    "dog": "-w 1 -dog 2 3",
    "log": "-w 1 -log 2",
    "ggauss": "-w 1 -ggauss 2",
    "dogg": "-w 1 -dogg 2 3",
    "fluct": "-w 1 -fluct 3",
    "median": "-w 1 -median 2 -mask {d}/mask.mrc",
    "erode": "-w 1 -erode 2",
    "open": "-w 1 -open 2",
    "top_hat": "-w 1 -top-hat-black 2",
    "template": "-w 1 -template-gauss 2 4",
    "doggxy": "-w 1 -doggxy 2 4 2",
    "connect_alone": "-w 1 -connect 0.5",
    # a volume the (4, 2) grid does not divide runs whole on every rank
    "undivided": MEMBRANE + " -in {d}/odd.mrc",
}


def _argv(d, case, tag, thr):
    """The command of ``case``; ``tag`` names its outputs ("two" for
    the cluster, "one" for one process)."""
    out = f"{d}/{case}_{tag}"
    return (f"-in {d}/in.mrc -out {out}.mrc -mesh 8 "
            + CASES[case].format(out=out, d=d, tag=tag, thr=thr)).split()


WORKER = """
import contextlib, io, json, sys, traceback
from datetime import timedelta
import torch
torch.set_num_threads(2)
import torch.distributed as dist
from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.parallel import distributed as D
d, cases = sys.argv[1], json.loads(sys.argv[2])
D.init_distributed(backend="gloo", timeout=timedelta(seconds=120))
rank = D.process_index()
writes = []
def spy(fn):
    def wrapped(path, *a, **k):
        writes.append(str(path))
        return fn(path, *a, **k)
    return wrapped
TFM.mrc.write_mrc = spy(TFM.mrc.write_mrc)
TFM.write_oriented_pointcloud_ply = spy(TFM.write_oriented_pointcloud_ply)
results = {}
for case, argv in cases:
    writes.clear()
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = TFM.run(argv, device="cpu", mesh_devices=["cpu"] * 4)
        error = None if rc == 0 else f"exit {rc}"
    except Exception:
        error = traceback.format_exc()
    results[case] = {"error": error, "stderr": err.getvalue(),
                     "writes": list(writes)}
    dist.barrier()
json.dump(results, open(f"{d}/results{rank}.json", "w"))
D.shutdown_distributed()
print(f"rank{rank}-done")
"""


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def phantom(tmp_path_factory):
    d = tmp_path_factory.mktemp("cluster")
    vol, _ = membrane_phantom(SHAPE, seed=3, thickness=2.5)
    mrc.write_mrc(str(d / "in.mrc"), vol.numpy())
    mask = np.ones(SHAPE, np.float32)
    mask[:, :, :6] = 0.0
    mrc.write_mrc(str(d / "mask.mrc"), mask)
    odd, _ = membrane_phantom((21, 28, 40), seed=4, thickness=2.5)
    mrc.write_mrc(str(d / "odd.mrc"), odd.numpy())
    # the -connect threshold: the 95th percentile of the stick score
    assert TFM.run(f"-in {d}/in.mrc -out {d}/score.mrc {MEMBRANE}".split(),
                   device="cpu", report=Report(None)) == 0
    thr = float(np.percentile(mrc.read_mrc(str(d / "score.mrc")).data, 95))
    return d, f"{thr:.6g}"


@pytest.fixture(scope="module")
def cluster(phantom):
    """Every case in two ranks: {case: [rank 0's, rank 1's record]}."""
    d, thr = phantom
    cases = [(c, _argv(d, c, "two", thr)) for c in CASES]
    spawn_ranks(WORKER, [d, json.dumps(cases)], timeout=600)
    recs = [json.load(open(d / f"results{r}.json")) for r in range(2)]
    return {c: [recs[0][c], recs[1][c]] for c in CASES}


@pytest.fixture(scope="module")
def one_process(phantom):
    """Every case in one process over ["cpu"] * 8: the same grid."""
    d, thr = phantom
    for c in CASES:
        assert TFM.run(_argv(d, c, "one", thr), device="cpu",
                       report=Report(None), mesh_devices=["cpu"] * 8) == 0
    return d


def _img(path):
    return mrc.read_mrc(str(path)).data


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_cli_equals_one_process(cluster, one_process, case):
    d = one_process
    rank0, rank1 = cluster[case]
    assert rank0["error"] is None, rank0["error"]
    assert rank1["error"] is None, rank1["error"]
    assert "writing tomogram" in rank0["stderr"]
    assert "skipping tomogram write" in rank1["stderr"]
    assert rank1["writes"] == []
    out = f"{d}/{case}_two"
    want = [f"{out}.mrc"]
    if case == "save":
        want = [f"{out}_tensor_{k}.rec" for k in range(6)] + want
    if case == "connect":
        want = [f"{out}.ply", f"{out}.mrc"]
    assert rank0["writes"] == want
    for path in want:
        one = path.replace("_two", "_one")
        if path.endswith(".ply"):
            assert open(path, "rb").read() == open(one, "rb").read()
        else:
            np.testing.assert_array_equal(_img(path), _img(one))


@pytest.mark.parametrize("case", ["membrane", "connect"])
def test_cluster_cli_matches_jax_mesh(cluster, phantom, monkeypatch, case):
    d, thr = phantom
    assert cluster[case][0]["error"] is None
    monkeypatch.setenv("VISFD_FUSED_EIGEN", "1")
    for k in ("VISFD_COORDINATOR", "VISFD_NUM_PROCESSES", "VISFD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert JFM.run(_argv(d, case, "jax", thr)) == 0
    got, want = _img(d / f"{case}_two.mrc"), _img(d / f"{case}_jax.mrc")
    if case == "connect":
        assert want.max() > 5                # several clusters
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("flag", [
    "-find-minima m.txt", "-find-maxima m.txt",
    "-watershed minima", "-watershed minima -watershed-device",
    "-blob minima b.txt 2 3 1.1", "-distance-points p.txt",
    "-distance-to-voxels p.txt d.txt 0 1",
    "-random-spheres r.txt 10 3 0 1 5", "-draw-spheres b.txt",
    "-discard-blobs a.txt b.txt", "-supervised-multi f.txt",
    "-blob-radial-intensity min b.txt r"])
def test_cluster_refuses_unported_handlers(monkeypatch, flag):
    """Refused with the flag's name before the cluster is joined (the
    coordinator here is never contacted)."""
    monkeypatch.setenv("VISFD_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("VISFD_NUM_PROCESSES", "2")
    monkeypatch.setenv("VISFD_PROCESS_ID", "1")
    argv = f"-in x.mrc -out y.mrc -w 1 {flag} -mesh 8".split()
    name = flag.split()[0]
    with pytest.raises(InputError, match=f"{name}.* with -mesh in a "
                                         f"multi-process cluster"):
        TFM.run(argv, device="cpu")
