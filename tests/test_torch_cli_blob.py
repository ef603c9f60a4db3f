"""The port's CLI for the convolution filters, morphology and the blob
handlers against the JAX CLI, its -mesh runs against its single-device
runs, and volumes with a side below 3 voxels.

* The reference's ``test_blob_detection.sh`` pipeline
  (``tests/test_cli_pipelines.py:46-100``; its fixture is not in the
  repository), rebuilt on a seeded phantom of dark spheres with a mask
  at ``-w 19.6``: ``-dog 0 500`` (a 135-tap kernel), ``-cl``, ``-blob
  minima 160 280 1.01``, ``-discard-blobs -blob-separation 1.1
  -minima-threshold``, ``-draw-spheres``, ``-auto-thresh score
  -supervised`` and ``-supervised-multi``.  Each stage reads the same
  input files in both packages.
* Each filter flag, ``-blob`` in its spellings and the sphere options.
* ``-mesh 4`` on CPU blocks: every image and list bit for bit the
  port's single-device run.

Tolerances (the port on the CPU against the JAX CLI): images rtol 1e-5,
atol 1e-6 of the largest magnitude (the LoG: atol 2^-22 max|x| /
delta^2, its two blurs' roundings scaled by 1 / delta^2); median,
morphology, drawn spheres, NMS lists and thresholds exact (the image
``-blob`` draws has the blobs' scores as brightness: their tolerance);
blob lists as
in tests/test_torch_blob.py (coordinates and diameters exact, scores
rtol 1e-5 with the LoG's atol, near-ties below an extremum margin of
1e-4 counted and printed).
"""

import contextlib
import io
import pathlib

import numpy as np
import pytest
import torch

from visfd_tpu.cli import filter_mrc as JFM
from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.cli.settings import InputError
from visfd_tpu_torch.features import blob as TB
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.io.coords import read_blob_coords_file
from visfd_tpu_torch.ops import draw as TD
from visfd_tpu_torch.utils.phantom import blob_phantom
from visfd_tpu_torch.utils.progress import Report

W = 19.6
SHAPE = (30, 44, 52)
LADDER = "160 280 1.01"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def phantom(tmp_path_factory):
    """Dark spheres of 8-12 voxels (157-235 at -w 19.6) on noise, a mask,
    and the spheres' centres (z, y, x) in centres.npy."""
    d = tmp_path_factory.mktemp("blob")
    vol, mask, centres, _ = blob_phantom(SHAPE, seed=17, n_blobs=9,
                                         spacing=18, diameters=(8.0, 12.0))
    mrc.write_mrc(str(d / "in.mrc"), vol.numpy())
    mrc.write_mrc(str(d / "mask.mrc"), mask.numpy())
    np.save(d / "centres.npy", centres)
    return d


def _training_files(d, blob_file):
    """Training points (physical units): the phantom's centres as
    positives, the detected blobs more than 3 voxels from every centre
    (noise) as negatives."""
    centres = np.load(d / "centres.npy")[:, ::-1] * W
    found = _blobs(blob_file).crds
    dist = np.linalg.norm(found[:, None] - centres[None], axis=-1).min(1)
    neg = found[dist > 3 * W]
    assert len(neg) >= 3
    np.savetxt(d / "pos.txt", centres, fmt="%.3f")
    np.savetxt(d / "neg.txt", neg, fmt="%.3f")


def _img(path):
    return mrc.read_mrc(str(path)).data


def _torch_run(argv, mesh=None):
    return TFM.run(argv, device="cpu", report=Report(None),
                   mesh_devices=None if mesh is None else ["cpu"] * mesh)


def _run(run, args, capture=False):
    argv = args.split() if isinstance(args, str) else args
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        assert run(argv) == 0, buf.getvalue()[-2000:]
    return buf.getvalue()


def _both(d, args, name, text=None):
    """Both CLIs; ``{out}`` in ``args`` names a per-package stem.  Returns
    ((jax image, jax stderr), (torch image, torch stderr))."""
    outs = []
    for tag, run in (("jax", JFM.run), ("torch", _torch_run)):
        stem = d / f"{name}_{tag}"
        log = _run(run, f"{args} -out {stem}.mrc".format(out=stem))
        outs.append((_img(f"{stem}.mrc"), log))
    return outs


def _close(got, want, atol=None):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max()
                               if atol is None else atol)


def _blobs(path):
    crds, diams, scores, _ = read_blob_coords_file(str(path))
    return TB.BlobList(crds, diams, scores)


def _lists_match(a, b, x, mask, diams_vox, **log_kw):
    """Blob files of the JAX (``a``) and the port (``b``), physical
    units: returns the blobs in one list only (each a near-tie)."""
    ja, tb = _blobs(a), _blobs(b)
    ia, ib, only_a, only_b = TB.match_blob_lists(ja, tb)
    # the files hold 6 significant digits
    np.testing.assert_allclose(tb.scores[ib], ja.scores[ia], rtol=2e-5,
                               atol=2.0 ** -22 * np.abs(x).max() / 0.02 ** 2)
    sig = np.asarray(diams_vox) / (2 * np.sqrt(3.0))
    extra = []
    for bl, idx in ((ja, only_a), (tb, only_b)):
        for i in idx:
            k = int(np.argmin(np.abs(sig * 2 * np.sqrt(3.0) * W
                                     - bl.diameters[i])))
            zyx = np.round(bl.crds[i][::-1] / W).astype(np.int64)
            mg = TB.extremum_margins(torch.tensor(x), list(sig), zyx[None],
                                     [k], torch.tensor(mask), **log_kw)[0]
            print(f"near-tie blob {bl.crds[i]} d={bl.diameters[i]:.4g}: "
                  f"margin {mg:.3g}")
            assert mg < 1e-4
            extra.append(bl.take([i]))
    return extra


def _ladder(d_min, d_max, g):
    n = 1 + int(np.ceil(np.log(d_max / d_min) / np.log(g)))
    g = (d_max / d_min) ** (1.0 / n)
    out = [d_min]
    for _ in range(1, n):
        out.append(out[-1] * g)
    return out


# --- the reference's blob pipeline --------------------------------------------

def test_blob_detection_pipeline_matches_jax(phantom):
    d = phantom
    base = f"-w {W} -mask {d}/mask.mrc"
    # -dog 0 500: a delta minus a 135-tap Gaussian
    (a, _), (b, _) = _both(d, f"{base} -in {d}/in.mrc -dog 0 500", "dog")
    _close(b, a)
    # -cl on the JAX package's -dog output, in both
    (a, _), (b, _) = _both(d, f"{base} -in {d}/dog_jax.mrc -cl -1.3 1.3",
                           "dogcl")
    _close(b, a)
    # -blob minima: the lists (and the image, outside near-ties' spheres)
    x = _img(d / "in.mrc")
    mask = _img(d / "mask.mrc")
    (a, _), (b, _) = _both(d, f"{base} -in {d}/in.mrc -blob minima "
                              f"{{out}}.txt {LADDER}", "blob")
    extra = _lists_match(d / "blob_jax.txt", d / "blob_torch.txt", x, mask,
                         [v / W for v in _ladder(160.0, 280.0, 1.01)],
                         truncate_ratio=float(np.sqrt(-2 * np.log(0.03))))
    print(f"{len(extra)} near-tie candidates of "
          f"{len(_blobs(d / 'blob_jax.txt'))}")
    keep = np.ones(x.shape, bool)
    for bl in extra:
        keep &= TD.draw_spheres(x.shape, bl.crds / W, bl.diameters / W,
                                None, [1.0]).numpy() == 0
    # the spheres' brightness is the blobs' score
    _close(b[keep], a[keep], atol=2.0 ** -22 * np.abs(x).max() / 0.02 ** 2)
    assert len(_blobs(d / "blob_jax.txt")) > 5
    # -discard-blobs on the JAX package's list, in both
    nms = (f"{base} -in {d}/in.mrc -discard-blobs {d}/blob_jax.txt "
           f"{{out}}.txt -blob-separation 1.1 -minima-threshold -20")
    for tag, run in (("jax", JFM.run), ("torch", _torch_run)):
        _run(run, nms.format(out=d / f"nms_{tag}"))
    ja, tb = _blobs(d / "nms_jax.txt"), _blobs(d / "nms_torch.txt")
    assert (d / "nms_torch.txt").read_text() == \
        (d / "nms_jax.txt").read_text()
    assert 3 <= len(tb) < len(_blobs(d / "blob_jax.txt"))
    # single-voxel spheres: the masked sum is the number of blobs
    (a, _), (b, _) = _both(d, f"{base} -in {d}/dogcl_jax.mrc -draw-spheres "
                              f"{d}/nms_jax.txt -background 0 -foreground 1 "
                              f"-sphere-radii 0", "draw")
    np.testing.assert_array_equal(b, a)
    assert int(b[mask != 0].sum()) == len(tb)
    # supervised thresholds, single and pooled over two copies, trained
    # on the list the NMS leaves
    _run(JFM.run, f"{base} -in {d}/in.mrc -discard-blobs {d}/blob_jax.txt "
                  f"{d}/sep.txt -blob-separation 1.1")
    _training_files(d, d / "sep.txt")
    logs = []
    for tag, run in (("jax", JFM.run), ("torch", _torch_run)):
        logs.append(_run(run, f"{base} -in {d}/in.mrc -discard-blobs "
                              f"{d}/blob_jax.txt {d}/sup_{tag}.txt "
                              f"-blob-separation 1.1 -auto-thresh score "
                              f"-supervised {d}/pos.txt {d}/neg.txt"))
    assert (d / "sup_torch.txt").read_text() == \
        (d / "sup_jax.txt").read_text()

    def thresholds(log):
        return [ln.split(":")[1].strip() for ln in log.splitlines()
                if "threshold" in ln and "bound:" in ln]
    assert thresholds(logs[1]) == thresholds(logs[0]) != []
    with open(d / "multi.txt", "w") as f:
        for _ in range(2):
            f.write(f"{d}/pos.txt {d}/neg.txt {d}/sep.txt\n")
    multi = [thresholds(_run(run, f"-w {W} -in {d}/in.mrc -auto-thresh score "
                                  f"-supervised-multi {d}/multi.txt"))
             for run in (JFM.run, _torch_run)]
    assert multi[1] == multi[0] != []


# --- each filter flag ------------------------------------------------------------

FILTERS = {
    "gauss": "-gauss 30",
    "gauss-aniso-nonorm": "-gauss-aniso 30 40 25 -normalize-filters no",
    "ggauss": "-ggauss 40",
    "ggauss-exponent": "-ggauss 40 -exponent 3",
    "dog": "-dog 25 45",
    "dogg": "-dogg 25 45 -exponents 2 3",
    "log": "-log 40",
    "log-d": "-log-d 120 -dog-delta 0.05",
    "fluct": "-fluct 50",
    "fluct-exponent": "-fluct 50 -exponent 3",
    "median": "-median 40",
    "erode": "-erode 40",
    "dilate": "-dilate 30",
    "open": "-open 40",
    "close": "-close 40",
    "top-hat-white": "-top-hat-white 30",
    "top-hat-black": "-top-hat-black 30",
    "dilate-soft": "-dilation-binary-soft 30 50 2",
}
EXACT = ("median", "erode", "dilate", "open", "close", "top-hat-white",
         "top-hat-black", "dilate-soft")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(FILTERS))
def test_filter_flags_match_jax(phantom, name, masked):
    d = phantom
    m = f"-mask {d}/mask.mrc " if masked else ""
    (a, _), (b, _) = _both(d, f"-w {W} {m}-in {d}/in.mrc {FILTERS[name]}",
                           f"{name}{int(masked)}")
    if name in EXACT:
        np.testing.assert_array_equal(b, a)
    elif name.startswith("log"):
        delta = 0.05 if "delta" in FILTERS[name] else 0.02
        _close(b, a, atol=2.0 ** -22 * np.abs(_img(d / "in.mrc")).max()
               / delta ** 2)
    else:
        _close(b, a)
    assert np.isfinite(b).all() and b.std() > 0


BLOB_FLAGS = {
    "maxima-sigma": "-blob-s maxima {out}.txt 1.3 2.5 1.1",
    "all-radii": "-blob-r all {out} 70 140 1.1 -blob-separation 0.8",
    "minima-overlap": "-blob minima {out}.txt 150 280 1.05 "
                      "-max-volume-overlap 0.3 -sphere-shell-ratio 0.2",
    "minima-ratio": "-blob minima {out}.txt 150 280 1.05 -minima-ratio 0.5",
    "blob-d-aspect": "-blob-d minima {out}.txt 150 280 1.1 "
                     "-blob-aspect-ratio 1 1 0.9",
}


@pytest.mark.parametrize("name", list(BLOB_FLAGS))
def test_blob_flags_match_jax(phantom, name):
    d = phantom
    (a, _), (b, _) = _both(d, f"-w {W} -mask {d}/mask.mrc -in {d}/in.mrc "
                              f"{BLOB_FLAGS[name]}", f"b_{name}")
    outs = sorted(d.glob(f"b_{name}_jax*.txt"))
    assert outs
    for fa in outs:
        fb = pathlib.Path(str(fa).replace("_jax", "_torch"))
        ja, tb = _blobs(fa), _blobs(fb)
        ia, ib, only_a, only_b = TB.match_blob_lists(ja, tb)
        assert len(only_a) == len(only_b) == 0
        np.testing.assert_allclose(tb.scores, ja.scores, rtol=2e-5)
    # the spheres' brightness is the blobs' score
    _close(b, a, atol=2.0 ** -22 * np.abs(_img(d / "in.mrc")).max()
           / 0.02 ** 2)


DRAW = {
    "hollow": "-draw-hollow-spheres {blobs} -foreground 2",
    "scores-scaled": "-draw-spheres {blobs} -spheres-score -sphere-scale 1.5",
    "normalized": "-draw-spheres {blobs} -spheres-normalize -background-auto "
                  "-diameter 200",
    "thick-shells": "-draw-spheres {blobs} -sphere-shell-thickness 40 "
                    "-background 1",
}


@pytest.mark.parametrize("name", list(DRAW))
def test_draw_spheres_flags_match_jax(phantom, name):
    d = phantom
    blobs = d / "drawlist.txt"
    if not blobs.exists():
        _run(JFM.run, f"-w {W} -mask {d}/mask.mrc -in {d}/in.mrc -blob "
                      f"minima {blobs} 150 280 1.05")
    (a, _), (b, _) = _both(d, f"-w {W} -mask {d}/mask.mrc -in {d}/in.mrc "
                              + DRAW[name].format(blobs=blobs), f"d_{name}")
    np.testing.assert_array_equal(b, a)


# --- -mesh 4 against one device -----------------------------------------------------

MESH = {**{k: FILTERS[k] for k in FILTERS if k not in ("gauss-aniso-nonorm",
                                                       "ggauss-exponent",
                                                       "log-d")},
        "blob": "-blob all {out} 150 280 1.05",
        "dog-135-taps": "-dog 0 500"}


@pytest.mark.parametrize("name", list(MESH))
def test_mesh_equals_one_device(phantom, name):
    """-mesh 4 on CPU blocks (the 30 x 44 x 52 volume in (2, 2) blocks of
    15 x 22 planes and rows): the single-device bits, image and lists."""
    d = phantom
    res = []
    for mesh in (None, 4):
        stem = d / f"m_{name}_{mesh}"
        args = (f"-w {W} -mask {d}/mask.mrc -in {d}/in.mrc "
                f"{MESH[name]} -out {stem}.mrc").format(out=stem)
        if mesh:
            args += " -mesh 4"
        _run(lambda a: _torch_run(a, mesh), args)
        res.append((_img(f"{stem}.mrc"),
                    [p.read_text() for p in sorted(d.glob(f"m_{name}_{mesh}"
                                                          f"*.txt"))]))
    np.testing.assert_array_equal(res[1][0], res[0][0])
    assert res[1][1] == res[0][1]
    if name == "blob":
        assert len(res[0][1]) == 2 and all(res[0][1])


# --- a side below 3 voxels ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 24, 32), (24, 2, 32)])
def test_thin_volumes_match_jax(tmp_path, shape):
    """A side of 2 voxels: the filters and -blob give the JAX CLI's
    output; -membrane/-curve/-edge are refused by both CLIs (the JAX
    CLI's route for such a volume raises in its edge clamp)."""
    rng = np.random.default_rng(30)
    mrc.write_mrc(str(tmp_path / "in.mrc"),
                  rng.normal(size=shape).astype(np.float32))
    base = f"-in {tmp_path}/in.mrc -w 1"
    for name, flag in (("gauss", "-gauss 1.5"), ("dogg", "-dogg 1 2"),
                       ("median", "-median 1.5"), ("open", "-open 1"),
                       ("blob", "-blob all {out} 2 5 1.2")):
        (a, _), (b, _) = _both(tmp_path, f"{base} {flag}", name)
        if name in ("median", "open"):
            np.testing.assert_array_equal(b, a)
        else:
            _close(b, a)
    for flag in ("-membrane minima 1.5 -tv 1", "-curve maxima 1.5 -tv 1",
                 "-edge minima 1.5 -tv 1"):
        argv = f"{base} {flag} -out {tmp_path}/m.mrc".split()
        with pytest.raises(ValueError, match="edge"):
            JFM.run(argv)
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf):
            with pytest.raises(InputError, match="at least 3 voxels"):
                _torch_run(argv)
        assert "route:" in buf.getvalue()
