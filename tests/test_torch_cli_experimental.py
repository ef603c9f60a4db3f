"""The port's CLI for the experimental handlers against the JAX CLI:
``-template-gauss`` (and ``-template-gaussian``, ``-template-gauss-aniso``),
``-doggxy`` (and ``-doggxy-aniso``), ``-distance-points``,
``-distance-to-voxels``, ``-random-spheres`` and
``-blob-radial-intensity`` (and ``-blob-intensity-vs-radius``), with and
without ``-mask``, on a seeded phantom of dark spheres; and
``-template-gauss`` / ``-doggxy`` under ``-mesh 4`` on CPU blocks, bit
for bit the port's single-device run.

Tolerances (the port on the CPU against the JAX CLI): the template
amplitude absolute, 2^-20 * max|x| * sum|w Q_| (its kernel has zero mean
and x - background cancels; tests/test_torch_experimental.py);
``-doggxy`` rtol 1e-5, atol 1e-6 of the largest magnitude; the distance
maps, the occupancy image and every written text file equal.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from visfd_tpu.cli import filter_mrc as JFM
from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.ops import kernels as TK
from visfd_tpu_torch.utils.phantom import blob_phantom
from visfd_tpu_torch.utils.progress import Report

SHAPE = (24, 30, 36)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def phantom(tmp_path_factory):
    """Dark spheres on noise, a mask, and three coordinate files: points
    in physical units at -w 2 (pts.txt), points in IMOD's 1-based voxel
    notation (pts_imod.txt), and blobs with diameters (blobs.txt)."""
    d = tmp_path_factory.mktemp("exp")
    vol, mask, centres, _ = blob_phantom(SHAPE, seed=23, n_blobs=6,
                                         spacing=12, diameters=(6.0, 9.0))
    mrc.write_mrc(str(d / "in.mrc"), vol.numpy())
    mrc.write_mrc(str(d / "mask.mrc"), mask.numpy())
    rng = np.random.default_rng(24)
    pts = rng.uniform(0, 1, (9, 3)) * np.array(SHAPE[::-1])
    np.savetxt(d / "pts.txt", pts * 2.0, fmt="%.3f")
    with open(d / "pts_imod.txt", "w") as fh:
        for p in pts:
            fh.write(f"({p[0] + 1:.0f}, {p[1] + 1:.0f}, {p[2] + 1:.0f})\n")
    blobs = np.concatenate([centres[:, ::-1] * 2.0,
                            np.full((len(centres), 1), 15.0)], 1)
    np.savetxt(d / "blobs.txt", blobs, fmt="%.3f")
    return d


def _torch_run(argv, mesh=None):
    return TFM.run(argv, device="cpu", report=Report(None),
                   mesh_devices=None if mesh is None else ["cpu"] * mesh)


def _run(run, args):
    argv = args.split() if isinstance(args, str) else args
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        assert run(argv) == 0, buf.getvalue()[-2000:]
    return buf.getvalue()


def _img(path):
    return mrc.read_mrc(str(path)).data


def _both(d, args, name):
    """Both CLIs on ``args``; ``{tag}`` in ``args`` names a per-package
    file.  Returns the (jax, torch) output images."""
    outs = []
    for tag, run in (("jax", JFM.run), ("torch", _torch_run)):
        _run(run, f"{args} -out {d}/{name}_{tag}.mrc".format(tag=tag))
        outs.append(_img(d / f"{name}_{tag}.mrc"))
    return outs


def _template_atol(x, wa, wr, ratio=2.5):
    hws = tuple(max(1, int(np.floor(r * ratio))) for r in wr)
    w = TK.gen_gauss_kernel_3d(wr, 2.0, hws, normalize=False)
    q = TK.gen_gauss_kernel_3d(wa, 2.0, hws, normalize=False)
    q_ = q - float((w * q).sum() / w.sum())
    q_ = q_ / np.sqrt((w * q_ * q_).sum())
    return 2.0 ** -20 * float(np.abs(x).max()) * float(np.abs(w * q_).sum())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("flag,wa,wr", [
    ("-template-gauss 2 4", (2.0,) * 3, (4.0,) * 3),
    ("-template-gaussian 1.5 3", (1.5,) * 3, (3.0,) * 3),
    ("-template-gauss-aniso 1.5 2 1.2 3 3.5 2.5", (1.5, 2.0, 1.2),
     (3.0, 3.5, 2.5))])
def test_template_gauss_matches_jax(phantom, masked, flag, wa, wr):
    d = phantom
    m = f"-mask {d}/mask.mrc " if masked else ""
    j, t = _both(d, f"-w 1 {m}-in {d}/in.mrc {flag}", "tg")
    x = _img(d / "in.mrc")
    if masked:
        # masked voxels are written as 0 (-template-gauss's -mask-out 0)
        assert (t[_img(d / "mask.mrc") == 0] == 0).all()
    err = float(np.abs(t - j).max())
    atol = _template_atol(x, wa, wr)
    print(f"{flag}: max|d| {err:.3g} (atol {atol:.3g})")
    assert err <= atol


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("flag", ["-doggxy 1 2 1.5",
                                  "-doggxy-aniso 1 1.3 2 2.6 0.8",
                                  "-doggxy 1 2 1.5 -exponents 1.5 2.5"])
def test_doggxy_matches_jax(phantom, masked, flag):
    d = phantom
    m = f"-mask {d}/mask.mrc " if masked else ""
    j, t = _both(d, f"-w 1 {m}-in {d}/in.mrc {flag}", "dx")
    np.testing.assert_allclose(t, j, rtol=1e-5,
                               atol=1e-6 * float(np.abs(j).max()))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pts,w", [("pts.txt", 2.0), ("pts_imod.txt", 1.0)])
def test_distance_points_matches_jax(phantom, masked, pts, w):
    d = phantom
    m = f"-mask {d}/mask.mrc " if masked else ""
    j, t = _both(d, f"-w {w} {m}-in {d}/in.mrc -distance-points {d}/{pts}",
                 "dp")
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("masked", [False, True])
def test_distance_to_voxels_matches_jax(phantom, masked):
    d = phantom
    m = f"-mask {d}/mask.mrc " if masked else ""
    j, t = _both(d, f"-w 2 {m}-in {d}/in.mrc -distance-to-voxels "
                    f"{d}/pts.txt {d}/dist_{{tag}}.txt -10 -0.5", "dv")
    np.testing.assert_array_equal(t, j)
    got = (d / "dist_torch.txt").read_text()
    assert got == (d / "dist_jax.txt").read_text()
    assert len(got.splitlines()) == 9


@pytest.mark.parametrize("masked", [False, True])
def test_random_spheres_matches_jax(phantom, masked):
    d = phantom
    m = f"-mask {d}/mask.mrc " if masked else ""
    j, t = _both(d, f"-w 2 {m}-in {d}/in.mrc -random-spheres "
                    f"{d}/rs_{{tag}}.txt 5 6 -0.5 10 3", "rs")
    np.testing.assert_array_equal(t, j)
    got = (d / "rs_torch.txt").read_text()
    assert got == (d / "rs_jax.txt").read_text()
    assert len(got.splitlines()) == 5


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("flag", ["-blob-radial-intensity min",
                                  "-blob-intensity-vs-radius max",
                                  "-blob-radial-intensity center"])
def test_blob_radial_intensity_matches_jax(phantom, masked, flag):
    d = phantom
    m = f"-mask {d}/mask.mrc " if masked else ""
    j, t = _both(d, f"-w 2 {m}-in {d}/in.mrc {flag} {d}/blobs.txt "
                    f"{d}/prof_{{tag}}", "br")
    np.testing.assert_array_equal(t, j)
    files = sorted(d.glob("prof_jax_*.txt"))
    assert files
    for fj in files:
        ft = d / fj.name.replace("prof_jax", "prof_torch")
        assert ft.read_text() == fj.read_text()
        fj.unlink()
        ft.unlink()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("flag", ["-template-gauss 2 4", "-doggxy 1 2 1.5"])
def test_mesh_equals_one_device(phantom, masked, flag):
    """-mesh 4 on CPU blocks (the 24 x 30 x 36 volume in (2, 2) blocks,
    halos as deep as the 21^3 template kernel) bit for bit one device."""
    d = phantom
    m = f"-mask {d}/mask.mrc " if masked else ""
    outs = []
    for mesh in (None, 4):
        o = d / f"mesh_{mesh}.mrc"
        argv = f"-w 1 {m}-in {d}/in.mrc -out {o} {flag}".split()
        if mesh:
            argv += ["-mesh", "4"]
        _run(lambda a: _torch_run(a, mesh), argv)
        outs.append(_img(o))
    np.testing.assert_array_equal(outs[1], outs[0])
