"""The blob-list writer, ``io/coords.write_blob_coords_file``, which
formats its rows in native code (``native.format_rows_g6``), against the
loop of one ``fmt_g`` a value that it replaced, byte for byte; its round
trip through ``read_blob_coords_file``; and the ``-blob`` handler's count
of the rows it wrote.

Imports neither JAX nor the JAX package, so the file also runs where the
port runs (``python -m pytest --noconftest tests/test_torch_coords.py``),
with that machine's compiler.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.io.coords import (
    CHUNK_ROWS, fmt_g, read_blob_coords_file, write_blob_coords_file)
from visfd_tpu_torch.utils.phantom import blob_phantom
from visfd_tpu_torch.utils.progress import Report

W = 19.6


def _fmt_g_rows(crds, diameters, scores) -> bytes:
    """The writer as it was: one ``fmt_g`` a value."""
    return "".join(
        f"{fmt_g(x)} {fmt_g(y)} {fmt_g(z)} {fmt_g(d)} {fmt_g(s)}\n"
        for (x, y, z), d, s in zip(crds, diameters, scores)).encode()


def _written(tmp_path, crds, diameters, scores) -> bytes:
    path = tmp_path / "blobs.txt"
    write_blob_coords_file(str(path), crds, diameters, scores)
    return path.read_bytes()


def _cell_like(n, seed):
    """Rows of the blob cell's shape: voxel centres at 19.6 A, the
    ladder's diameters, float32 scores."""
    rng = np.random.default_rng(seed)
    crds = rng.integers(0, 1024, (n, 3)) * W
    diams = rng.choice(np.geomspace(160.0, 280.0, 56), n)
    scores = (rng.standard_normal(n) * 0.05).astype(np.float32)
    return crds, diams, scores


def _decades(n, seed):
    """Rows over +-24 decades, both signs, every mantissa."""
    rng = np.random.default_rng(seed)

    def col(size):
        return (rng.choice([-1.0, 1.0], size) * rng.uniform(1, 10, size)
                * 10.0 ** rng.integers(-24, 25, size))

    return col((n, 3)), np.abs(col(n)), col(n)


EDGES = {
    "zero": 0.0,
    "negative-zero": -0.0,
    "smallest-subnormal": 5e-324,
    "negative-subnormal": -5e-324,
    "subnormal": 1.234567e-310,
    "largest-subnormal": 2.225073858507201e-308,
    "smallest-normal": 2.2250738585072014e-308,
    "largest-double": np.finfo(np.float64).max,
    "negative-largest-double": -np.finfo(np.float64).max,
    "inf": np.inf,
    "negative-inf": -np.inf,
    "nan": np.nan,
    "negative-nan": np.copysign(np.nan, -1.0),
    "999999.5": 999999.5,
    "9999995": 9999995.0,
    "9.999995e-5": 9.999995e-5,
    "1e16": 1e16,
    "100000": 100000.0,
    "1000000": 1000000.0,
    "0.0001": 0.0001,
    "-123456.5": -123456.5,
}


@pytest.mark.parametrize("name", list(EDGES))
def test_edge_values_match_fmt_g(tmp_path, name):
    v = EDGES[name]
    crds = np.array([[v, 1.0, -2.5], [3.0, v, 0.1], [7.0, 8.0, v]])
    diams = np.array([v, 160.0, 280.0])
    scores = np.array([-0.5, 0.25, v])
    assert (_written(tmp_path, crds, diams, scores)
            == _fmt_g_rows(crds, diams, scores))


@pytest.mark.parametrize("rows", [_cell_like, _decades])
def test_bulk_rows_match_fmt_g(tmp_path, rows):
    crds, diams, scores = rows(10 ** 5, seed=21)
    assert (_written(tmp_path, crds, diams, scores)
            == _fmt_g_rows(crds, diams, scores))


@pytest.mark.parametrize("n", [0, 1, CHUNK_ROWS - 1, CHUNK_ROWS,
                               CHUNK_ROWS + 1])
def test_row_counts_match_fmt_g(tmp_path, n):
    crds, diams, scores = _cell_like(n, seed=n)
    got = _written(tmp_path, crds, diams, scores)
    assert got == _fmt_g_rows(crds, diams, scores)
    assert got.count(b"\n") == n


@pytest.mark.parametrize("rows", [_cell_like, _decades])
def test_round_trip_through_reader(tmp_path, rows):
    crds, diams, scores = rows(2000, seed=5)
    path = tmp_path / "blobs.txt"
    write_blob_coords_file(str(path), crds, diams, scores)
    got_crds, got_diams, got_scores, in_voxels = read_blob_coords_file(
        str(path))

    def as_read(a):
        return np.vectorize(lambda v: float(fmt_g(v)))(np.asarray(a))

    assert not in_voxels
    np.testing.assert_array_equal(got_crds, as_read(crds))
    np.testing.assert_array_equal(got_diams, as_read(diams))
    np.testing.assert_array_equal(got_scores, as_read(scores))


@pytest.fixture(scope="module")
def phantom(tmp_path_factory):
    d = tmp_path_factory.mktemp("blob_rows")
    vol, mask, _, _ = blob_phantom((30, 44, 52), seed=17, n_blobs=9,
                                   spacing=18, diameters=(8.0, 12.0))
    mrc.write_mrc(str(d / "in.mrc"), vol.numpy())
    mrc.write_mrc(str(d / "mask.mrc"), mask.numpy())
    return d


@pytest.mark.parametrize("kind", ["minima", "all"])
def test_blob_run_counts_rows_written(phantom, tmp_path, kind):
    d = phantom
    out = tmp_path / kind
    argv = (f"-w {W} -mask {d}/mask.mrc -in {d}/in.mrc -blob {kind} {out} "
            f"160 280 1.05").split()
    rep = Report(None)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            assert TFM.run(argv, device="cpu", report=rep) == 0
    finally:
        torch.set_num_threads(prev)
    lists = sorted(tmp_path.glob(f"{kind}*"))
    assert len(lists) == (1 if kind == "minima" else 2)
    rows = sum(p.read_bytes().count(b"\n") for p in lists)
    assert rows > 0
    assert rep.counts[TFM.BLOB_ROWS_WRITTEN] == rows
