"""filter_mrc -mesh in a two-process cluster on the CPU over gloo.

Two ranks (subprocesses through ``spawn_ranks`` of
``tests/test_torch_distributed.py``) each run ``run(argv, device="cpu",
mesh_devices=["cpu"] * 4)`` on ``tests/test_torch_cli.py``'s phantom,
(Z, Y, X) = (20, 28, 40): the global grid is the (4, 2) of the
one-process ``-mesh 8`` over ``["cpu"] * 8``, blocks (5, 14).  The
commands: every handler.  The sharded ones run over the global grid:
the flagship (with ``-connect``, ``-normals-file``,
``-save/-load-progress``, ``-save/-load-progress-sharded``, ``-cl``), ``-edge``, ``-curve``, ``-bin 2``
with ``-connect`` (a (24, 28, 40) phantom, binned to (12, 14, 20)), the
stand-alone ``-connect``, the separable, dense and median filters,
morphology, ``-template-gauss``, ``-doggxy``, ``-watershed-device``
(with ``-markers`` and ``-undefined-out max`` too) and ``-blob`` (on a
phantom of dark spheres); the others whole on every rank:
``-find-minima/-maxima``, the host ``-watershed``, ``-discard-blobs``,
``-supervised-multi``, ``-draw-spheres``, ``-distance-points``,
``-distance-to-voxels``, ``-random-spheres`` and
``-blob-radial-intensity`` (on a blob list the fixture writes); and a
volume the grid does not divide (run whole on every rank).  For each:

* rank 0 writes every file (tomograms, PLYs, text lists) and prints
  ``writing tomogram`` where the command writes one; rank 1 writes
  nothing and prints ``skipping tomogram write``.  The one exception is
  ``-save-progress-sharded``: each rank writes the block files of its
  own blocks (rank 1 those of grid rows 2 and 3), rank 0 alone
  ``metadata.json``; the save and the load move nothing through the
  process group (``parallel/distributed.traffic`` gains no bytes during
  them);
* every file equals the one-process ``-mesh 8`` run's bit for bit
  (``-supervised-multi`` writes none: its thresholds are compared; a
  checkpoint's every block file and ``metadata.json``); the two
  checkpoints load without a mesh to the same arrays and the same
  output (the cluster's score, computed on its (4, 2) blocks, may differ
  by an ulp from a whole volume's on the CPU, where the twins' SIMD
  loops leave a block's last voxels to scalar code: that comparison is
  ``chip_smoke.py`` phase 13's, on the card, bit for bit);
* the flagship (with and without ``-connect``), ``-blob``,
  ``-watershed-device`` and the ``-bin 2 … -connect`` command agree
  with the JAX CLI's ``-mesh 8`` run (its Pallas kernels in interpret
  mode): the score to rtol 2e-4 / atol 2e-5 of the largest (the TV
  tolerance), the labels equal (as ``tests/test_torch_cli_connect.py``
  holds them), the blob lists equal but for near-ties (extremum margin
  below 1e-4, as ``tests/test_torch_cli_blob.py`` holds them).

Each command runs once in the two ranks, the ranks meeting at a barrier
after it (``-load-progress`` reads what rank 0 wrote); a failure is
recorded per command.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from visfd_tpu.cli import filter_mrc as JFM
from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.cli import settings as S
from visfd_tpu_torch.features import blob as TB
from visfd_tpu_torch.io import checkpoint as CK
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.io.coords import read_blob_coords_file
from visfd_tpu_torch.utils.phantom import blob_phantom, membrane_phantom
from visfd_tpu_torch.utils.progress import Report

from test_torch_distributed import spawn_ranks

SHAPE = (20, 28, 40)
MEMBRANE = "-w 1 -membrane minima 2.5 -tv 1.0 -tv-angle-exponent 4"
BLOB = "-blob minima {out}.txt 3 6 1.1"
BLOBS = "-w 1 -in {d}/blobs.mrc "      # the phantom of dark spheres
CASES = {
    "membrane": MEMBRANE,
    "connect": MEMBRANE + " -connect {thr} -connect-angle 30 "
                          "-select-cluster 1 -normals-file {out}.ply",
    "save": MEMBRANE + " -save-progress {out}",
    "load": MEMBRANE + " -load-progress {d}/save_{tag} -connect {thr} "
                       "-connect-angle 30",
    "save_sharded": MEMBRANE + " -save-progress-sharded {out}_ck",
    "load_sharded": MEMBRANE + " -load-progress-sharded "
                               "{d}/save_sharded_{tag}_ck",
    "intensity": MEMBRANE + " -cl -1 1.5",
    "edge": "-w 1 -edge minima 1.5 -tv 1.0 -tv-angle-exponent 4",
    "curve": "-w 1 -curve minima 2.5 -tv 1.0 -tv-angle-exponent 4",
    # the JAX package's two-process golden's command, on a phantom whose
    # binned volume the (4, 2) grid divides
    "bin": "-w 1 -in {d}/bin.mrc -bin 2 -membrane minima 4 -tv 2 "
           "-tv-angle-exponent 4 -connect {bthr} -connect-angle 30",
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
    "find_minima": "-w 1 -find-minima {out}.txt",
    "find_maxima": "-w 1 -find-maxima {out}.txt -neighbor-connectivity 1 "
                   "-mask {d}/mask.mrc",
    "watershed": "-w 1 -watershed minima",
    "watershed_device": "-w 1 -watershed minima -watershed-device",
    "watershed_markers": "-w 1 -watershed minima -watershed-device "
                         "-markers {d}/markers.mrc",
    "watershed_undefined": "-w 1 -watershed maxima -watershed-device "
                           "-watershed-threshold 0 -undefined-out max "
                           "-mask {d}/mask.mrc",
    "blob": BLOBS + BLOB + " -mask {d}/mask.mrc",
    "discard": BLOBS + "-discard-blobs {d}/blobs.txt {out}.txt "
                       "-blob-separation 1.1",
    "supervised_multi": BLOBS + "-auto-thresh score -supervised-multi "
                                "{d}/multi.txt",
    "draw_spheres": BLOBS + "-draw-spheres {d}/blobs.txt -foreground 5",
    "distance_points": "-w 1 -distance-points {d}/blobs.txt "
                       "-mask {d}/mask.mrc",
    "distance_voxels": BLOBS + "-distance-to-voxels {d}/blobs.txt {out}.txt "
                               "-1e9 0",
    "random_spheres": "-w 1 -random-spheres {out}.txt 10 3 -1e9 1e9 5",
    "radial": BLOBS + "-blob-radial-intensity min {d}/blobs.txt {out}_r",
    # a volume the (4, 2) grid does not divide runs whole on every rank
    "undivided": MEMBRANE + " -in {d}/odd.mrc",
}


def _argv(d, case, tag, thr):
    """The command of ``case``; ``tag`` names its outputs ("two" for
    the cluster, "one" for one process)."""
    out = f"{d}/{case}_{tag}"
    return (f"-in {d}/in.mrc -out {out}.mrc -mesh 8 "
            + CASES[case].format(out=out, d=d, tag=tag, **thr)).split()


def _written(d, case, tag, rank=0):
    """The files ``case`` writes on ``rank``, in the order it writes
    them."""
    out = f"{d}/{case}_{tag}"
    if case == "save_sharded":
        # each rank its own blocks of the (4, 2) grid: rank 0 rows 0-1
        blocks = [f"{out}_ck.partial/{name}.{iz}.{iy}.npy"
                  for name in ("vote", "saliency", "direction")
                  for iz in (2 * rank, 2 * rank + 1) for iy in range(2)]
        return blocks + ([f"{out}_ck.partial/metadata.json", f"{out}.mrc"]
                         if rank == 0 else [])
    if rank:
        return []
    lists = {"find_minima", "find_maxima", "blob", "distance_voxels",
             "random_spheres"}
    if case == "save":
        return [f"{out}_tensor_{k}.rec" for k in range(6)] + [f"{out}.mrc"]
    if case == "connect":
        return [f"{out}.ply", f"{out}.mrc"]
    if case == "discard":
        return [f"{out}.txt"]
    if case == "supervised_multi":
        return []
    if case == "radial":
        n = len(read_blob_coords_file(f"{d}/blobs.txt")[2])
        return [f"{out}_r_{i + 1}.txt" for i in range(n)] + [f"{out}.mrc"]
    return ([f"{out}.txt"] if case in lists else []) + [f"{out}.mrc"]


WORKER = """
import contextlib, io, json, sys, traceback
from datetime import timedelta
import torch
torch.set_num_threads(2)
from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.io import checkpoint as CK
from visfd_tpu_torch.parallel import distributed as D
d, cases = sys.argv[1], json.loads(sys.argv[2])
D.init_distributed(backend="gloo", timeout=timedelta(seconds=120))
rank = D.process_index()
writes, moved = [], []
def count_traffic(fn):
    # the bytes every kind of exchange moved during the call
    def total():
        return sum(v["bytes_sent"] + v["bytes_received"]
                   for v in D.traffic.values())
    def wrapped(*a, **k):
        before = total()
        out = fn(*a, **k)
        moved.append(total() - before)
        return out
    return wrapped
TFM.save_sharded = count_traffic(TFM.save_sharded)
TFM.load_sharded = count_traffic(TFM.load_sharded)
def spy(fn):
    def wrapped(path, *a, **k):
        writes.append(str(path))
        return fn(path, *a, **k)
    return wrapped
TFM.mrc.write_mrc = spy(TFM.mrc.write_mrc)
TFM.write_oriented_pointcloud_ply = spy(TFM.write_oriented_pointcloud_ply)
TFM.write_blob_coords_file = spy(TFM.write_blob_coords_file)
def spy_open(path, mode="r", *a, **k):
    # filter_mrc's own text files (lists, distances, profiles)
    if any(c in mode for c in "wax+"):
        writes.append(str(path))
    return open(path, mode, *a, **k)
TFM.open = spy_open
CK.open = spy_open
results = {}
for case, argv in cases:
    writes.clear()
    moved.clear()
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = TFM.run(argv, device="cpu", mesh_devices=["cpu"] * 4)
        error = None if rc == 0 else f"exit {rc}"
    except Exception:
        error = traceback.format_exc()
    results[case] = {"error": error, "stderr": err.getvalue(),
                     "writes": list(writes), "moved": list(moved)}
    D.barrier()
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


def _score_percentile(argv, path):
    """The 95th percentile of the stick score of ``argv``'s output."""
    assert TFM.run(argv.split(), device="cpu", report=Report(None)) == 0
    return f"{float(np.percentile(mrc.read_mrc(path).data, 95)):.6g}"


@pytest.fixture(scope="module")
def phantom(tmp_path_factory):
    """The inputs, a blob list of the spheres' phantom and the training
    files of -supervised-multi; the -connect thresholds: (directory,
    {"thr": ..., "bthr": ...})."""
    d = tmp_path_factory.mktemp("cluster")
    vol, _ = membrane_phantom(SHAPE, seed=3, thickness=2.5)
    mrc.write_mrc(str(d / "in.mrc"), vol.numpy())
    mask = np.ones(SHAPE, np.float32)
    mask[:, :, :6] = 0.0
    mrc.write_mrc(str(d / "mask.mrc"), mask)
    odd, _ = membrane_phantom((21, 28, 40), seed=4, thickness=2.5)
    mrc.write_mrc(str(d / "odd.mrc"), odd.numpy())
    binned, _ = membrane_phantom((24, 28, 40), seed=5, thickness=4.0)
    mrc.write_mrc(str(d / "bin.mrc"), binned.numpy())
    markers = np.zeros(SHAPE, np.float32)
    rng = np.random.default_rng(6)
    for lab in range(1, 6):
        markers[tuple(rng.integers(0, SHAPE))] = lab
    mrc.write_mrc(str(d / "markers.mrc"), markers)
    blobs, _, centres, _ = blob_phantom(SHAPE, seed=7, n_blobs=6,
                                        spacing=12, diameters=(4.0, 6.0))
    mrc.write_mrc(str(d / "blobs.mrc"), blobs.numpy())
    assert TFM.run(f"-w 1 -in {d}/blobs.mrc -out {d}/b.mrc "
                   f"{BLOB.format(out=d / 'blobs')}".split(), device="cpu",
                   report=Report(None)) == 0
    found = read_blob_coords_file(str(d / "blobs.txt"))[0]
    assert len(found) >= 4
    np.savetxt(d / "pos.txt", centres[:, ::-1], fmt="%.3f")
    dist = np.linalg.norm(found[:, None] - centres[None, :, ::-1],
                          axis=-1).min(1)
    np.savetxt(d / "neg.txt", found[dist > 2], fmt="%.3f")
    with open(d / "multi.txt", "w") as f:
        for _ in range(2):
            f.write(f"{d}/pos.txt {d}/neg.txt {d}/blobs.txt\n")
    return d, {
        "thr": _score_percentile(f"-in {d}/in.mrc -out {d}/score.mrc "
                                 f"{MEMBRANE}", d / "score.mrc"),
        "bthr": _score_percentile(
            f"-in {d}/bin.mrc -out {d}/bscore.mrc -w 1 -bin 2 -membrane "
            f"minima 4 -tv 2 -tv-angle-exponent 4", d / "bscore.mrc")}


@pytest.fixture(scope="module")
def cluster(phantom):
    """Every case in two ranks: {case: [rank 0's, rank 1's record]}."""
    d, thr = phantom
    cases = [(c, _argv(d, c, "two", thr)) for c in CASES]
    spawn_ranks(WORKER, [d, json.dumps(cases)], timeout=900)
    recs = [json.load(open(d / f"results{r}.json")) for r in range(2)]
    return {c: [recs[0][c], recs[1][c]] for c in CASES}


@pytest.fixture(scope="module")
def one_process(phantom):
    """Every case in one process over ["cpu"] * 8, the same grid:
    (directory, {case: stderr})."""
    d, thr = phantom
    logs = {}
    for c in CASES:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert TFM.run(_argv(d, c, "one", thr), device="cpu",
                           report=Report(None),
                           mesh_devices=["cpu"] * 8) == 0, c
        logs[c] = err.getvalue()
    return d, logs


def _img(path):
    return mrc.read_mrc(str(path)).data


def _thresholds(log):
    """The score thresholds -supervised-multi reports."""
    return [ln.split(":")[1].strip() for ln in log.splitlines()
            if "threshold" in ln and "bound:" in ln]


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_cli_equals_one_process(cluster, one_process, case):
    d, logs = one_process
    rank0, rank1 = cluster[case]
    assert rank0["error"] is None, rank0["error"]
    assert rank1["error"] is None, rank1["error"]
    assert rank1["writes"] == _written(d, case, "two", rank=1)
    want = _written(d, case, "two")
    assert rank0["writes"] == want
    if want and want[-1].endswith(".mrc"):
        assert "writing tomogram" in rank0["stderr"]
        assert "skipping tomogram write" in rank1["stderr"]
    if case.endswith("_sharded"):
        # one save_sharded or load_sharded call a rank, nothing moved
        assert rank0["moved"] == rank1["moved"] == [0]
        want = want + _written(d, case, "two", rank=1)
    for path in want:
        path = path.replace(".partial/", "/")     # the saved checkpoint
        one = path.replace("_two", "_one")
        if path.endswith((".mrc", ".rec")):
            np.testing.assert_array_equal(_img(path), _img(one))
        else:
            assert open(path, "rb").read() == open(one, "rb").read()
    if case == "supervised_multi":
        assert _thresholds(rank0["stderr"]) == _thresholds(logs[case]) != []


def _blob_lists_match(d, got, want):
    """Blob files of the port and of the JAX CLI (-w 1: voxels): the
    same blobs but for near-ties (extremum margin below 1e-4), scores
    to 6 digits (what the files hold).  Returns whether both lists are
    the same blobs."""
    s = S.parse_args(f"-in x -w 1 {BLOB.format(out='b')}".split())
    sig = [dd / (2 * np.sqrt(3.0)) for dd in s.blob_diameters]
    tr = (s.filter_truncate_ratio if s.filter_truncate_ratio > 0
          else float(np.sqrt(-2.0 * np.log(s.filter_truncate_threshold))))
    x, mask = _img(d / "blobs.mrc"), _img(d / "mask.mrc")
    a, b = (TB.BlobList(*read_blob_coords_file(str(p))[:3])
            for p in (got, want))
    ia, ib, only_a, only_b = TB.match_blob_lists(a, b)
    assert len(ia) >= 4
    np.testing.assert_allclose(a.scores[ia], b.scores[ib], rtol=2e-5,
                               atol=2.0 ** -22 * np.abs(x).max() / 0.02 ** 2)
    for bl, idx in ((a, only_a), (b, only_b)):
        for i in idx:
            k = int(np.argmin(np.abs(np.asarray(s.blob_diameters)
                                     - bl.diameters[i])))
            zyx = np.round(bl.crds[i][::-1]).astype(np.int64)
            assert TB.extremum_margins(
                torch.tensor(x), sig, zyx[None], [k], torch.tensor(mask),
                delta_sigma_over_sigma=s.delta_sigma_over_sigma,
                truncate_ratio=tr)[0] < 1e-4
    return not len(only_a) and not len(only_b)


@pytest.mark.parametrize("case", ["membrane", "connect", "blob",
                                  "watershed_device", "bin"])
def test_cluster_cli_matches_jax_mesh(cluster, phantom, monkeypatch, case):
    d, thr = phantom
    assert cluster[case][0]["error"] is None
    monkeypatch.setenv("VISFD_FUSED_EIGEN", "1")
    for k in ("VISFD_COORDINATOR", "VISFD_NUM_PROCESSES", "VISFD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert JFM.run(_argv(d, case, "jax", thr)) == 0
    got, want = _img(d / f"{case}_two.mrc"), _img(d / f"{case}_jax.mrc")
    if case == "blob":
        if _blob_lists_match(d, d / "blob_two.txt", d / "blob_jax.txt"):
            np.testing.assert_allclose(got, want, rtol=2e-4,
                                       atol=2e-5 * np.abs(want).max())
    elif case == "membrane":
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-5 * np.abs(want).max())
    else:
        assert want.max() > 2                # several labels
        np.testing.assert_array_equal(got, want)


def test_cluster_checkpoint_loads_without_a_mesh(cluster, one_process):
    """The two ranks' checkpoint and one process's (both of the (4, 2)
    grid) restore whole to the same arrays, and ``-load-progress-sharded``
    without a mesh gives the same output from either."""
    d, _ = one_process
    assert cluster["save_sharded"][0]["error"] is None
    two, one = (f"{d}/save_sharded_{t}_ck" for t in ("two", "one"))
    got, want = (CK.load_sharded(p, device="cpu") for p in (two, one))
    assert sorted(got) == ["direction", "saliency", "vote"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    outs = []
    for p in (two, one):
        o = f"{p}_whole.mrc"
        assert TFM.run(f"-in {d}/in.mrc -out {o} {MEMBRANE} "
                       f"-load-progress-sharded {p}".split(), device="cpu",
                       report=Report(None)) == 0
        outs.append(_img(o))
    assert np.abs(outs[0]).max() > 0
    np.testing.assert_array_equal(outs[0], outs[1])
