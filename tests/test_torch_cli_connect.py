"""The port's CLI beyond the vote score: -connect, -normals-file,
-save/-load-progress, -must-link and -edge.

* The C++ reference's goldens (``tests/golden/``), bit for bit on the
  CPU.  After ``-load-progress`` the labels depend only on the loaded
  vote tensors, so a zero volume of the input's shape (16^3, binned to
  8^3) stands in for the reference's tomogram; ``-connect 37`` runs on
  ``ref_gauss.mrc`` itself.  PLYs to the JAX golden tests' tolerances.
* The port's CLI (``device="cpu"``: the kernels' plain twins) against
  the JAX CLI (``VISFD_FUSED_EIGEN=1``, Pallas in interpret mode) on a
  seeded phantom: ``-membrane … -tv … -connect … -select-cluster 1
  -normals-file`` gives equal labels and PLY; ``-edge … -tv`` agrees to
  the TV tolerance (rtol 2e-4, atol 2e-5 of the largest output);
  ``-save-progress`` writes .rec files equal to JAX's to atol 5e-6 of
  the largest, and ``-load-progress`` of them gives JAX's labels
  (``-save/-load-progress-sharded``: tests/test_torch_checkpoint.py;
  ``-mesh`` with ``-connect``, ``-edge`` and ``-normals-file`` runs:
  tests/test_torch_cli_segment.py).
"""

import pathlib

import numpy as np
import pytest
import torch

from visfd_tpu.cli import filter_mrc as JFM
from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.io.pointcloud import read_ply_pointcloud
from visfd_tpu_torch.utils.phantom import membrane_phantom

GOLDEN = pathlib.Path(__file__).parent / "golden"
SHAPE = (20, 28, 40)
MEMBRANE = "-w 1 -membrane minima 2.5 -tv 1.0 -tv-angle-exponent 4"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def zero_input(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden")
    mrc.write_mrc(str(d / "zero.mrc"), np.zeros((16, 16, 16), np.float32))
    return d


@pytest.fixture(scope="module")
def phantom(tmp_path_factory):
    d = tmp_path_factory.mktemp("phantom")
    vol, _ = membrane_phantom(SHAPE, seed=3, thickness=2.5)
    mrc.write_mrc(str(d / "in.mrc"), vol.numpy())
    return d


def _img(path):
    return mrc.read_mrc(str(path)).data


def _ply_close(ours, ref, scale=None):
    (c, n), (c_r, n_r) = read_ply_pointcloud(ours), read_ply_pointcloud(ref)
    assert c.shape == c_r.shape and len(c) > 0
    np.testing.assert_allclose(c, c_r, atol=1e-3)       # %g prints
    nscale = np.abs(n_r).max() if scale is None else scale
    np.testing.assert_allclose(n, n_r, atol=1e-4 * nscale)


GOLDEN_CASES = {
    # filter_mrc ... -load-progress P -connect 1e+09 -connect-angle 30
    #   -normals-file ref_memb.ply -select-cluster 1
    "memb_conn": ("-connect 1e+09 -connect-angle 30 -normals-file {ply} "
                  "-select-cluster 1", "ref_memb.ply"),
    # ... -connect 5e+09 -connect-angle 10 (two fragments)
    "memb_frag": ("-connect 5e+09 -connect-angle 10", None),
    # ... the fragments joined again by an IMOD-notation -must-link file
    "memb_ml": ("-connect 5e+09 -connect-angle 10 -must-link {g}/ref_ml.txt "
                "-select-cluster 1 -normals-file {ply}", "ref_memb_ml.ply"),
}


@pytest.mark.parametrize("case", list(GOLDEN_CASES))
def test_golden_from_reference_tensors(zero_input, case):
    extra, ref_ply = GOLDEN_CASES[case]
    d = zero_input
    out, ply = d / f"{case}.mrc", d / f"{case}.ply"
    argv = (f"-w 19.2 -in {d}/zero.mrc -out {out} -membrane minima 55 -tv 4 "
            f"-tv-angle-exponent 4 -bin 2 -load-progress {GOLDEN}/ref_prog "
            + extra.format(ply=ply, g=GOLDEN)).split()
    assert TFM.run(argv, device="cpu") == 0
    np.testing.assert_array_equal(_img(out), _img(GOLDEN / f"ref_{case}.mrc"))
    if ref_ply:
        _ply_close(ply, GOLDEN / ref_ply)


def test_golden_connect_stand_alone(tmp_path):
    # filter_mrc -in ref_gauss.mrc -out ref_conn.mrc -connect 37 -w 1
    out = tmp_path / "conn.mrc"
    assert TFM.run(f"-in {GOLDEN}/ref_gauss.mrc -out {out} -w 1 -connect 37"
                   .split(), device="cpu") == 0
    ref = _img(GOLDEN / "ref_conn.mrc")
    np.testing.assert_array_equal(_img(out), ref)
    assert ref.max() == 7.0  # 6 clusters, undefined voxels at N + 1


def test_golden_connect_undefined_out(tmp_path):
    """-undefined-out sets the voxels of no cluster (N + 1 by default)."""
    out = tmp_path / "conn.mrc"
    assert TFM.run(f"-in {GOLDEN}/ref_gauss.mrc -out {out} -w 1 -connect 37 "
                   f"-undefined-out -2.5".split(), device="cpu") == 0
    ref = _img(GOLDEN / "ref_conn.mrc")
    np.testing.assert_array_equal(_img(out), np.where(ref == 7.0, -2.5, ref))


def _run_both(d, args, name, monkeypatch):
    """Both CLIs on the phantom; returns the (jax, torch) outputs.  A
    ``{out}`` in ``args`` names a per-package file."""
    monkeypatch.setenv("VISFD_FUSED_EIGEN", "1")
    outs = []
    for tag, run in (("jax", JFM.run),
                     ("torch", lambda a: TFM.run(a, device="cpu"))):
        argv = (f"-in {d}/in.mrc -out {d}/{name}_{tag}.mrc "
                + args.format(out=f"{d}/{name}_{tag}")).split()
        assert run(argv) == 0
        outs.append(_img(d / f"{name}_{tag}.mrc"))
    return outs


def _stick_threshold(d):
    """A -connect threshold from the phantom's stick-score distribution
    (its 95th percentile; the scores are ~1e-2, not the 8-bit
    tomograms' ~1e9)."""
    out = d / "score.mrc"
    if not out.exists():
        assert TFM.run(f"-in {d}/in.mrc -out {out} {MEMBRANE}".split(),
                       device="cpu") == 0
    return float(np.percentile(_img(out), 95))


def test_cli_connect_matches_jax(phantom, monkeypatch):
    thr = _stick_threshold(phantom)
    a, b = _run_both(phantom, f"{MEMBRANE} -connect {thr:.6g} -connect-angle "
                     f"30 -select-cluster 1 -normals-file {{out}}.ply",
                     "conn", monkeypatch)
    assert a.max() > 5                       # several clusters
    np.testing.assert_array_equal(b, a)
    _ply_close(phantom / "conn_torch.ply", phantom / "conn_jax.ply")


def test_cli_normals_max_distance_matches_jax(phantom, monkeypatch):
    """-max-voxels-to-feature drops the points whose ridge lies farther
    away (both packages' walkers, the same PLY)."""
    thr = _stick_threshold(phantom)
    a, b = _run_both(phantom, f"{MEMBRANE} -connect {thr:.6g} -connect-angle "
                     f"30 -select-cluster 1 -max-voxels-to-feature 0.02 "
                     f"-normals-file {{out}}.ply", "maxd", monkeypatch)
    np.testing.assert_array_equal(b, a)
    _ply_close(phantom / "maxd_torch.ply", phantom / "maxd_jax.ply")
    # without the flag 304 of the cluster's 318 voxels give a point
    n = len(read_ply_pointcloud(phantom / "maxd_torch.ply")[0])
    assert 0 < n < 0.9 * (a == 1).sum()


def test_cli_edge_matches_jax(phantom, monkeypatch):
    a, b = _run_both(phantom, "-w 1 -edge minima 1.5 -tv 1.0 "
                     "-tv-angle-exponent 4", "edge", monkeypatch)
    assert np.isfinite(b).all() and np.abs(a).max() > 0
    np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-5 * np.abs(a).max())


def test_cli_edge_connect_matches_jax(phantom, monkeypatch):
    """-edge votes channel-last through features/tv; -connect then reads
    that vote and its principal_sym3 vector in place."""
    a, _ = _run_both(phantom, "-w 1 -edge minima 1.5 -tv 1.0 -tv-best 1.0",
                     "edge_s", monkeypatch)
    thr = float(np.percentile(a, 90))
    a, b = _run_both(phantom, f"-w 1 -edge minima 1.5 -tv 1.0 -tv-best 1.0 "
                     f"-connect {thr:.6g} -connect-angle 45", "edge_c",
                     monkeypatch)
    assert a.max() > 2
    np.testing.assert_array_equal(b, a)


def test_save_load_progress_round_trip(phantom, monkeypatch):
    _run_both(phantom, f"{MEMBRANE} -save-progress {{out}}", "prog",
              monkeypatch)
    for ch in range(6):
        want = _img(phantom / f"prog_jax_tensor_{ch}.rec")
        got = _img(phantom / f"prog_torch_tensor_{ch}.rec")
        np.testing.assert_allclose(got, want,
                                   atol=5e-6 * np.abs(want).max())
    # both packages resume from the same (JAX-written) tensors
    thr = _stick_threshold(phantom)
    a, b = _run_both(phantom, f"{MEMBRANE} -load-progress "
                     f"{phantom}/prog_jax -connect {thr:.6g} -connect-angle 30",
                     "resume", monkeypatch)
    assert a.max() > 5
    np.testing.assert_array_equal(b, a)


def test_save_load_progress_under_mesh(phantom):
    """-save-progress and -load-progress with -mesh write and read the
    single-device run's tensors (to the twins' CPU tolerance)."""
    d = phantom
    common = f"-in {d}/in.mrc {MEMBRANE}"
    for tag, extra in (("one", ""), ("mesh", " -mesh 4")):
        assert TFM.run(f"{common} -out {d}/sv_{tag}.mrc -save-progress "
                       f"{d}/sv_{tag}{extra}".split(), device="cpu",
                       mesh_devices=["cpu"] * 4) == 0
        assert TFM.run(f"{common} -out {d}/ld_{tag}.mrc -load-progress "
                       f"{d}/sv_one{extra}".split(), device="cpu",
                       mesh_devices=["cpu"] * 4) == 0
    for ch in range(6):
        want = _img(d / f"sv_one_tensor_{ch}.rec")
        np.testing.assert_allclose(_img(d / f"sv_mesh_tensor_{ch}.rec"), want,
                                   rtol=2e-4, atol=2e-5 * np.abs(want).max())
    want = _img(d / "ld_one.mrc")
    np.testing.assert_allclose(_img(d / "ld_mesh.mrc"), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
