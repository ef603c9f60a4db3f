"""The port's nine companion tools against the JAX package's
(``visfd_tpu.cli.*``), on the cases of tests/test_cli_tools.py and a few
more (masks, thresholds, rescaling), on the CPU.

Equal byte for byte: the printed lines of ``sum_voxels``,
``print_mrc_stats``, ``histogram_mrc`` and ``draw_filter_1d``, and the
files ``crop_mrc``, ``convert_to_float`` and ``voxelize_mesh`` write.
``combine_mrc``'s and ``pval_mrc``'s outputs: the combined volume equal
(elementwise float32 arithmetic and the same ramps), ``pval_mrc``'s
numbers to rtol 1e-5 (its blur sums in another order) and the extreme's
voxel equal.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from visfd_tpu.cli import combine_mrc as JCM
from visfd_tpu.cli import convert_to_float as JCF
from visfd_tpu.cli import crop_mrc as JCR
from visfd_tpu.cli import draw_filter_1d as JDF
from visfd_tpu.cli import histogram_mrc as JHG
from visfd_tpu.cli import print_mrc_stats as JPS
from visfd_tpu.cli import pval_mrc as JPV
from visfd_tpu.cli import sum_voxels as JSV
from visfd_tpu.cli import voxelize_mesh as JVM
from visfd_tpu_torch.cli import combine_mrc as TCM
from visfd_tpu_torch.cli import convert_to_float as TCF
from visfd_tpu_torch.cli import crop_mrc as TCR
from visfd_tpu_torch.cli import draw_filter_1d as TDF
from visfd_tpu_torch.cli import histogram_mrc as THG
from visfd_tpu_torch.cli import print_mrc_stats as TPS
from visfd_tpu_torch.cli import pval_mrc as TPV
from visfd_tpu_torch.cli import sum_voxels as TSV
from visfd_tpu_torch.cli import voxelize_mesh as TVM
from visfd_tpu_torch.io import mrc


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cpu(run):
    return lambda args: run(args, device="cpu")


def _out(run, args):
    """(exit code, stdout) of one run; stderr swallowed."""
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = run([str(a) for a in args])
    return rc, buf.getvalue()


def _same_stdout(jrun, trun, args):
    rj, oj = _out(jrun, args)
    rt, ot = _out(trun, args)
    assert rt == rj == 0
    assert ot == oj
    return ot


@pytest.fixture(scope="module")
def vols(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(41)
    a = rng.normal(size=(6, 7, 8)).astype(np.float32)
    b = (rng.normal(size=(6, 7, 8)) + 2.0).astype(np.float32)
    m = (rng.uniform(size=(6, 7, 8)) > 0.4).astype(np.float32)
    m[0] = 2.0
    mrc.write_mrc(str(d / "a.mrc"), a, voxel_width=2.0)
    mrc.write_mrc(str(d / "b.mrc"), b, voxel_width=2.0)
    mrc.write_mrc(str(d / "m.mrc"), m, voxel_width=2.0)
    return d


# --- combine_mrc ---------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ["{d}/a.mrc", "+", "{d}/b.mrc"], ["{d}/a.mrc", "-", "{d}/b.mrc"],
    ["{d}/a.mrc", "*", "{d}/b.mrc"], ["{d}/a.mrc", "/", "{d}/b.mrc"],
    ["{d}/a.mrc,0.5", "+", "{d}/b.mrc"],
    ["{d}/a.mrc,-0.5,0.5", "*", "{d}/b.mrc,1,2,3,4"],
    ["-mask", "{d}/m.mrc", "{d}/a.mrc", "+", "{d}/b.mrc"],
    ["-mask", "{d}/m.mrc", "-mask-select", "1", "-mask-out", "-3",
     "{d}/a.mrc", "-", "{d}/b.mrc"],
    ["-rescale", "{d}/a.mrc", "*", "{d}/b.mrc"],
    ["-mask", "{d}/m.mrc", "{d}/a.mrc", "+", "{d}/b.mrc", ",1,2"],
    ["{d}/a.mrc,0,0.3", "*", "{d}/b.mrc,0.1,0.7,1.9,2.6"],
])
def test_combine_mrc_matches_jax(vols, args):
    d = vols
    outs = []
    for tag, run in (("jax", JCM.run), ("torch", _cpu(TCM.run))):
        argv = [a.format(d=d) for a in args]
        if argv[-1].startswith(","):
            suffix = argv.pop()
        else:
            suffix = ""
        argv.append(f"{d}/c_{tag}.mrc{suffix}")
        rc, _ = _out(run, argv)
        assert rc == 0
        outs.append((d / f"c_{tag}.mrc").read_bytes())
    assert outs[1] == outs[0]


def test_combine_mrc_refuses(vols):
    d = vols
    for run in (JCM.run, _cpu(TCM.run)):
        assert _out(run, [f"{d}/a.mrc", "%", f"{d}/b.mrc", f"{d}/o.mrc"])[0] \
            == 1
        assert _out(run, [f"{d}/a.mrc", "+"])[0] == 1


# --- sum_voxels -----------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    [], ["-ave"], ["-stddev"], ["-volume"], ["-vol", "-w", "3"],
    ["-thresh", "0.2"], ["-thresh2", "-0.5", "0.5"], ["-clip", "-0.5", "0.5"],
    ["-thresh2", "-0.3", "0.4", "-ave"], ["-clip", "0.1", "0.7", "-stddev"],
    ["-thresh4", "-1", "-0.2", "0.3", "1.1"], ["-thresh4", "1", "0.5", "-0.5",
                                               "-1", "-ave"],
    ["-mask", "{d}/m.mrc"], ["-mask", "{d}/m.mrc", "-mask-select", "1",
                             "-ave"],
    ["-mask", "{d}/m.mrc", "-thresh2", "-0.5", "0.5", "-stddev"],
])
def test_sum_voxels_matches_jax(vols, opts):
    args = [o.format(d=vols) for o in opts] + [f"{vols}/a.mrc"]
    out = _same_stdout(JSV.run, _cpu(TSV.run), args)
    assert len(out.splitlines()) == 1


# --- pval_mrc -------------------------------------------------------------------

def _pval_rows(text):
    return [ln.split() for ln in text.strip().splitlines()]


@pytest.fixture(scope="module")
def particles(tmp_path_factory):
    """Scattered and clustered particle images (tests/test_cli_tools.py),
    a mask and a coordinate file."""
    d = tmp_path_factory.mktemp("pval")
    rng = np.random.default_rng(42)
    n = 24
    scattered = np.zeros((n, n, n), np.float32)
    scattered.ravel()[rng.choice(n ** 3, size=40, replace=False)] = 1.0
    clustered = np.zeros((n, n, n), np.float32)
    clustered[10:13, 10:13, 10:13] = 1.0
    mask = np.ones((n, n, n), np.float32)
    mask[:, :, :4] = 0.0
    mrc.write_mrc(str(d / "s.mrc"), scattered)
    mrc.write_mrc(str(d / "c.mrc"), clustered)
    mrc.write_mrc(str(d / "m.mrc"), mask)
    np.savetxt(d / "crds.txt", rng.uniform(0, n, (30, 3)), fmt="%.2f")
    return d


@pytest.mark.parametrize("opts", [
    ["-in", "{d}/s.mrc", "-gauss", "3", "-pmax"],
    ["-in", "{d}/c.mrc", "-gauss", "3", "-pmax"],
    ["-in", "{d}/c.mrc", "-gauss", "2", "-pmin", "-mask", "{d}/m.mrc"],
    ["-in", "{d}/s.mrc", "-gauss-sweep", "1.5", "4", "1.4", "-max", "-w",
     "2"],
    ["-in", "{d}/c.mrc", "-crds", "{d}/crds.txt", "-gauss", "2.5", "-max",
     "-truncate", "2"],
    ["-image-size", "24", "24", "24", "-crds", "{d}/crds.txt", "-gauss", "3",
     "-max", "-n", "25", "-vol", "13824"],
])
def test_pval_mrc_matches_jax(particles, opts):
    args = [o.format(d=particles) for o in opts]
    rj, oj = _out(JPV.run, args)
    rt, ot = _out(_cpu(TPV.run), args)
    assert rt == rj == 0
    j, t = _pval_rows(oj), _pval_rows(ot)
    assert len(t) == len(j) > 0
    for rowj, rowt in zip(j, t):
        assert rowt[2:5] == rowj[2:5]  # the extreme's voxel
        np.testing.assert_allclose([float(v) for v in rowt[:2] + rowt[5:]],
                                   [float(v) for v in rowj[:2] + rowj[5:]],
                                   rtol=1e-5)


def test_pval_mrc_clustered_below_scattered(particles):
    """tests/test_cli_tools.py's case on the port: the clump's p-value is
    smaller."""
    d = particles
    p = [float(_out(_cpu(TPV.run), ["-in", f"{d}/{f}.mrc", "-gauss", "3",
                                    "-pmax"])[1].split()[0])
         for f in ("s", "c")]
    assert 0 <= p[1] < p[0] <= 1


def test_pval_mrc_writes_blur(particles, tmp_path):
    d = particles
    outs = []
    for tag, run in (("jax", JPV.run), ("torch", _cpu(TPV.run))):
        o = tmp_path / f"{tag}.mrc"
        assert _out(run, ["-in", f"{d}/c.mrc", "-gauss", "2", "-out", o])[0] \
            == 0
        outs.append(mrc.read_mrc(str(o)).data)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5,
                               atol=1e-6 * float(np.abs(outs[0]).max()))


# --- the host tools -------------------------------------------------------------

@pytest.mark.parametrize("bounds", [
    ["1", "4", "2", "5", "0", "3"],
    ["1", "4", "2", "5", "0", "3", "1", "2", "0", "0", "0", "0", "9"],
    ["-2", "40", "3", "3", "1", "9", "0", "1", "2", "0", "1", "1"]])
def test_crop_mrc_matches_jax(vols, tmp_path, bounds):
    files = []
    for tag, run in (("jax", JCR.run), ("torch", TCR.run)):
        o = tmp_path / f"{tag}.mrc"
        assert _out(run, [f"{vols}/a.mrc", o] + bounds)[0] == 0
        files.append(o.read_bytes())
    assert files[1] == files[0]


def test_convert_to_float_matches_jax(tmp_path):
    h = mrc.MrcHeader(nvoxels=(3, 2, 2), mode=mrc.MODE_SHORT)
    raw = mrc._write_header(h) + np.arange(-6, 6, dtype="<i2").tobytes()
    p = tmp_path / "in.mrc"
    p.write_bytes(raw)
    files = []
    for tag, run in (("jax", JCF.run), ("torch", TCF.run)):
        o = tmp_path / f"{tag}.mrc"
        assert _out(run, [p, o])[0] == 0
        files.append(o.read_bytes())
    assert files[1] == files[0]
    assert mrc.read_mrc(str(tmp_path / "torch.mrc")).header.mode == \
        mrc.MODE_FLOAT


def test_print_mrc_stats_matches_jax(vols):
    out = _same_stdout(JPS.run, TPS.run, [f"{vols}/a.mrc"])
    assert out


@pytest.mark.parametrize("opts", [["-n", "10"], [], ["-n", "7", "-rescale"],
                                  ["-n", "5", "-mask", "{d}/m.mrc"],
                                  ["-m", "{d}/m.mrc", "-mask-select", "2"]])
def test_histogram_mrc_matches_jax(vols, opts):
    args = [o.format(d=vols) for o in opts] + [f"{vols}/a.mrc"]
    out = _same_stdout(JHG.run, THG.run, args)
    if opts[:2] == ["-n", "10"]:
        rows = [ln.split() for ln in out.strip().splitlines()]
        assert len(rows) == 10 and sum(int(r[1]) for r in rows) == 6 * 7 * 8


@pytest.mark.parametrize("args", [
    ["-gauss", "1.0", "2.0", "5"], ["-ggauss", "1", "2", "1.5"],
    ["-dog", "1", "0.5", "2", "4"], ["-dogg", "1", "0.5", "2", "4", "2", "1.5"],
    ["-log", "2", "0.1", "8"]])
def test_draw_filter_1d_matches_jax(args):
    out = _same_stdout(JDF.run, TDF.run, args)
    assert len(out.splitlines()) == 401


def _cube_ply(path):
    v = np.array([[x, y, z] for z in (2.0, 7.0) for y in (2.0, 7.0)
                  for x in (2.0, 7.0)])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 2, 6, 4),
             (1, 5, 7, 3), (0, 4, 5, 1), (2, 3, 7, 6)]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(v)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {len(quads)}\n"
                "property list uchar int vertex_indices\nend_header\n")
        for p in v:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        for q in quads:
            f.write(f"4 {q[0]} {q[1]} {q[2]} {q[3]}\n")


@pytest.mark.parametrize("opts", [
    ["-b", "0", "10", "0", "10", "0", "10", "-w", "1"],
    ["-c", "1", "8", "0", "9", "2", "6", "-w", "0.5"],
    ["-w", "0.7", "-s", "0.5", "0", "1"]])
def test_voxelize_mesh_matches_jax(tmp_path, opts):
    ply = tmp_path / "cube.ply"
    _cube_ply(ply)
    files = []
    for tag, run in (("jax", JVM.run), ("torch", TVM.run)):
        o = tmp_path / f"{tag}.mrc"
        assert _out(run, ["-m", ply, "-o", o] + opts)[0] == 0
        files.append(o.read_bytes())
    assert files[1] == files[0]
    occ = mrc.read_mrc(str(tmp_path / "torch.mrc")).data
    assert occ.sum() > 0
