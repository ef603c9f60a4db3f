"""The port's CLI for the segmentation handlers and the intensity map,
against the JAX CLI, and its -mesh runs against its single-device runs.

* ``-find-minima``/``-find-maxima`` (image and text files),
  ``-watershed minima|maxima`` (``-markers``, ``-watershed-threshold``,
  boundaries, ``-watershed-boundary``, ``-undefined-out``) and
  ``-watershed-device``, on ``tests/golden/ref_gauss.mrc`` (22 x 32 x
  27, the shape of ``ref_markers.mrc``) and a seeded phantom: the port
  (``device="cpu"``) equals the JAX CLI exactly.
* ``-watershed-device -mesh 8`` and ``-mesh 4`` with ``-membrane … -tv
  … -connect``, ``-edge … -tv``, ``-normals-file`` and the stand-alone
  ``-connect``, on CPU blocks: bit for bit the port's single-device
  labels, and the JAX CLI's (score maps to the tolerances at
  ``FLOAT_CASES``; PLYs to the golden tests' tolerances); score maps
  and PLYs equal the single-device ones bit for bit too.
* ``-thresh*``, ``-clip``, ``-thresh-gauss``, ``-rescale``, ``-fill``,
  ``-mask-rect``/``-mask-sphere`` and ``-image-size``: rtol 1e-6, atol
  1e-6 of the largest output against the JAX CLI.
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
from visfd_tpu_torch.utils.progress import Report

GOLDEN = pathlib.Path(__file__).parent / "golden"
GAUSS = f"-in {GOLDEN}/ref_gauss.mrc -w 1"
SHAPE = (20, 28, 40)
MEMBRANE = "-w 1 -membrane minima 2.5 -tv 1.0 -tv-angle-exponent 4"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def phantom(tmp_path_factory):
    d = tmp_path_factory.mktemp("segment")
    vol, _ = membrane_phantom(SHAPE, seed=7, thickness=2.5)
    mrc.write_mrc(str(d / "in.mrc"), vol.numpy())
    mask = np.ones(SHAPE, np.float32)
    mask[:, :, :5] = 0.0
    mrc.write_mrc(str(d / "mask.mrc"), mask)
    return d


def _img(path):
    return mrc.read_mrc(str(path)).data


def _torch_run(argv, mesh=None):
    return TFM.run(argv, device="cpu", report=Report(None),
                   mesh_devices=None if mesh is None else ["cpu"] * mesh)


def _both(d, args, name, text=None):
    """Both CLIs; returns ((jax image, jax text), (torch image, torch
    text)).  ``{out}`` in ``args`` names a per-package file and ``text``
    the suffix of a text file each writes."""
    outs = []
    for tag, run in (("jax", JFM.run), ("torch", _torch_run)):
        stem = d / f"{name}_{tag}"
        assert run(f"{args} -out {stem}.mrc".format(out=stem).split()) == 0
        txt = pathlib.Path(f"{stem}{text}") if text else None
        outs.append((_img(f"{stem}.mrc"),
                     txt.read_text() if txt and txt.exists() else None))
    return outs


EXTREMA = {
    "minima": "-find-minima {out}.txt",
    "maxima-conn1": "-find-maxima {out}.txt -neighbor-connectivity 1",
    "both-thresholds": "-find-minima {out}.txt -find-maxima {out}.max.txt "
                       "-minima-threshold 36 -maxima-threshold 38",
    "no-boundary": "-find-maxima {out}.txt -ignore-boundary-extrema "
                   "-neighbor-connectivity 2",
    "none-found": "-find-minima {out}.txt -minima-threshold -1e9",
}


@pytest.mark.parametrize("case", list(EXTREMA))
def test_find_extrema_matches_jax(tmp_path, case):
    (a, ta), (b, tb) = _both(tmp_path, f"{GAUSS} {EXTREMA[case]}", case,
                             text=".txt")
    np.testing.assert_array_equal(b, a)
    assert tb == ta
    if case == "none-found":      # an empty list writes no file
        assert ta is None
    else:
        assert ta and b.max() > 0


def test_find_extrema_masked_phantom_matches_jax(phantom):
    (a, ta), (b, tb) = _both(phantom, f"-in {phantom}/in.mrc -w 1.5 -mask "
                             f"{phantom}/mask.mrc -find-minima {{out}}.txt",
                             "ext", text=".txt")
    np.testing.assert_array_equal(b, a)
    assert tb == ta and len(ta.splitlines()) > 10


WATERSHED = {
    "minima": "-watershed minima",
    "maxima-threshold": "-watershed maxima -watershed-threshold 38",
    "minima-threshold-boundary-label": "-watershed minima "
                                       "-watershed-threshold 36.5 "
                                       "-watershed-boundary -4",
    "hide-boundaries": "-watershed minima -watershed-hide-boundaries",
    "markers": f"-watershed minima -markers {GOLDEN}/ref_markers.mrc",
    "markers-boundaries": f"-watershed minima -markers "
                          f"{GOLDEN}/ref_markers.mrc "
                          f"-watershed-show-boundaries",
    "undefined-max": "-watershed maxima -watershed-threshold 38 "
                     "-undefined-out max",
}


@pytest.mark.parametrize("device_flood", [False, True],
                         ids=["host", "device"])
@pytest.mark.parametrize("case", list(WATERSHED))
def test_watershed_matches_jax(tmp_path, case, device_flood):
    args = f"{GAUSS} {WATERSHED[case]}"
    if device_flood:
        args += " -watershed-device"
    (a, _), (b, _) = _both(tmp_path, args, case)
    np.testing.assert_array_equal(b, a)
    assert b.max() > 1


@pytest.mark.parametrize("args", [
    "-watershed minima -watershed-device -watershed-show-boundaries",
    "-watershed maxima -watershed-device -watershed-threshold 0.5 "
    "-neighbor-connectivity 3",
    "-watershed minima -watershed-device -mask {d}/mask.mrc",
])
def test_watershed_device_mesh(phantom, args):
    """-watershed-device -mesh 8 on (4, 2) CPU blocks (the phantom's
    (Z, Y) divide evenly): the single-device labels bit for bit, and
    the JAX CLI's (which shards over its 8 host devices)."""
    args = f"-in {phantom}/in.mrc -w 1 " + args.format(d=phantom)
    out1, out8 = phantom / "ws1.mrc", phantom / "ws8.mrc"
    assert _torch_run(f"{args} -out {out1}".split()) == 0
    assert _torch_run(f"{args} -out {out8} -mesh 8".split(), mesh=8) == 0
    np.testing.assert_array_equal(_img(out8), _img(out1))
    assert JFM.run(f"{args} -out {phantom}/wsj.mrc".split()) == 0
    np.testing.assert_array_equal(_img(out1), _img(phantom / "wsj.mrc"))


def _stick_threshold(d):
    out = d / "score.mrc"
    if not out.exists():
        assert _torch_run(f"-in {d}/in.mrc -out {out} {MEMBRANE}".split()) \
            == 0
    return float(np.percentile(_img(out), 95))


def _ply_close(ours, ref):
    (c, n), (c_r, n_r) = read_ply_pointcloud(ours), read_ply_pointcloud(ref)
    assert c.shape == c_r.shape and len(c) > 0
    np.testing.assert_allclose(c, c_r, atol=1e-3)
    np.testing.assert_allclose(n, n_r, atol=1e-4 * np.abs(n_r).max())


MESH_CASES = {
    "connect-normals": "{m} -connect {t:.6g} -connect-angle 30 "
                       "-select-cluster 1 -normals-file {out}.ply",
    "connect-mask": "{m} -connect {t:.6g} -connect-angle 30 -mask "
                    "{d}/mask.mrc",
    "edge": "-w 1 -edge minima 1.5 -tv 1.0 -tv-angle-exponent 4",
    "edge-connect": "-w 1 -edge minima 1.5 -tv 1.0 -tv-best 1.0 "
                    "-connect 0.02 -connect-angle 45",
    "normals-no-connect": "{m} -mask {d}/mask.mrc -normals-file {out}.ply",
}


# score maps, held to the JAX CLI's by tolerance (its eigen solvers differ)
FLOAT_CASES = ("edge", "normals-no-connect")


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_connect_edge_normals(phantom, monkeypatch, case):
    """-mesh 4 on (2, 2) CPU blocks: the single-device image and PLY bit
    for bit, and the JAX CLI's."""
    d = phantom
    args = MESH_CASES[case].format(m=MEMBRANE, t=_stick_threshold(d), d=d,
                                   out="{out}")
    outs = {}
    for tag, mesh in (("one", None), ("mesh", 4)):
        stem = d / f"{case}_{tag}"
        argv = (f"-in {d}/in.mrc -out {stem}.mrc "
                + args.format(out=stem)
                + (" -mesh 4" if mesh else "")).split()
        assert _torch_run(argv, mesh=mesh) == 0
        outs[tag] = _img(f"{stem}.mrc")
    one = outs["one"]
    np.testing.assert_array_equal(outs["mesh"], one)
    if case not in FLOAT_CASES:
        assert one.max() > 2
    if "{out}" in args:
        assert ((d / f"{case}_mesh.ply").read_bytes()
                == (d / f"{case}_one.ply").read_bytes())
    monkeypatch.setenv("VISFD_FUSED_EIGEN", "1")
    stem = d / f"{case}_jax"
    assert JFM.run((f"-in {d}/in.mrc -out {stem}.mrc "
                    + args.format(out=stem)).split()) == 0
    want = _img(f"{stem}.mrc")
    if case in FLOAT_CASES:
        np.testing.assert_allclose(one, want, rtol=2e-4,
                                   atol=2e-5 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(one, want)
    if "{out}" in args and case != "normals-no-connect":
        # (without -connect the PLY holds the Hessian's eigenvector at
        # every voxel, ill-defined where its eigenvalues nearly meet)
        _ply_close(d / f"{case}_one.ply", f"{stem}.ply")


def test_mesh_stand_alone_connect_golden(tmp_path):
    """The stand-alone -connect over (2, 2) CPU blocks of ref_gauss.mrc
    (22 x 32 x 27: Z and Y divide) gives the C++ golden."""
    out = tmp_path / "conn.mrc"
    assert _torch_run(f"{GAUSS} -out {out} -connect 37 -mesh 4".split(),
                      mesh=4) == 0
    np.testing.assert_array_equal(_img(out), _img(GOLDEN / "ref_conn.mrc"))


INTENSITY = {
    "thresh": "-thresh 37",
    "thresh2": "-thresh2 35 39",
    "thresh2-reversed-range": "-thresh2 39 35 -thresh-range -1 2",
    "thresh4": "-thresh4 34 36 38 40",
    "thresh4-inverted": "-thresh4 40 38 36 34",
    "thresh-interval": "-thresh-interval 36 38",
    "clip": "-clip 35 39",
    "clip-sigma-masked": "-cl -1 1.5 -mask-sphere 12 14 10 8",
    "thresh-gauss": "-thresh-gauss 37 1.5",
    "rescale": "-rescale 2.5 -90",
    "fill-mask-out": "-fill 3 -mask-rect 2 20 3 25 1 15 -mask-out -1",
    "mask-sphere-subtract": "-mask-rect 0 26 0 31 0 21 "
                            "-mask-sphere-subtract 13 15 10 6 -mask-out 0",
    "invert-thresh2": "-invert -thresh2 -39 -35",
    "rescale-min-max": "-thresh2 35 39 -rescale-min-max 1 5",
}


@pytest.mark.parametrize("case", list(INTENSITY))
def test_intensity_map_matches_jax(tmp_path, case):
    (a, _), (b, _) = _both(tmp_path, f"{GAUSS} {INTENSITY[case]}", case)
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("args", [
    "-image-size 27 22 14 -w 1 -mask-sphere 13 11 7 5 -thresh 0.5 -mask-out 2",
    "-image-size 30 20 10 -w 2 -mask-rect 2 40 4 30 2 12 "
    "-mask-rect-subtract 10 20 10 20 0 30 -fill 1 -mask-out -2",
    "-image-size 16 16 16 -mask-rect 2 9 2 9 2 9 -mask-rect-units-voxels "
    "-mask-out 5",
])
def test_image_size_and_masks_match_jax(tmp_path, args):
    (a, _), (b, _) = _both(tmp_path, args, "size")
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6 * np.abs(a).max())
    assert (a != a.flat[0]).any()
