"""Flags of the settings parser that change no filter: the port's CLI
against the JAX CLI on one seeded input.

* ``-mask-rect`` / ``-mask-sphere`` with each spelling of their units
  flag (``-mask-crds-units``, ``-mask-coords-units``,
  ``-mask-coordinates-units``, ``-mask-rect-units``), in voxels and in
  physical units: equal outputs;
* ``-np 4`` (a thread count, which both packages ignore), ``-norescale``
  and ``-no-rescale``: equal outputs;
* the renamed or disabled flags (``-surface``, ``-planar``,
  ``-planar-tv``, ``-bs``, ``--membrane-normals-file``): the same
  ``InputError`` message.

Outputs are ``-gauss`` images: rtol 1e-5, atol 1e-6 of the largest
magnitude (float32 sums in another order), and the masked voxels equal.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from visfd_tpu.cli import filter_mrc as JFM
from visfd_tpu.cli.settings import InputError as JInputError
from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.cli.settings import InputError
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.utils.progress import Report

SHAPE = (14, 18, 22)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    d = tmp_path_factory.mktemp("flags")
    x = np.random.default_rng(31).normal(size=SHAPE).astype(np.float32)
    mrc.write_mrc(str(d / "in.mrc"), x, voxel_width=2.0)
    return d


def _both(d, args, name):
    outs = []
    for tag, run in (("jax", JFM.run), ("torch", lambda a: TFM.run(
            a, device="cpu", report=Report(None)))):
        out = d / f"{name}_{tag}.mrc"
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf):
            assert run(f"-in {d}/in.mrc -out {out} {args}".split()) == 0, \
                buf.getvalue()[-2000:]
        outs.append(mrc.read_mrc(str(out)).data)
    return outs


def _close(t, j):
    np.testing.assert_allclose(t, j, rtol=1e-5,
                               atol=1e-6 * float(np.abs(j).max()))


@pytest.mark.parametrize("flag", ["-mask-crds-units", "-mask-coords-units",
                                  "-mask-coordinates-units",
                                  "-mask-rect-units"])
@pytest.mark.parametrize("units,rect", [("voxels", "3 15 2 12 1 9"),
                                        ("distance", "6 30 4 24 2 18")])
def test_mask_units_match_jax(volume, flag, units, rect):
    j, t = _both(volume, f"-gauss 1.5 -mask-rect {rect} -mask-sphere 10 8 "
                         f"6 4 -mask-out -7 {flag} {units}", "mu")
    _close(t, j)
    # the region is the same in both spellings of its units
    inside = t != -7
    assert 0 < inside.sum() < t.size
    np.testing.assert_array_equal(inside, j != -7)
    assert inside[1:10, 2:13, 3:16].all()


@pytest.mark.parametrize("flag", ["-np 4", "-norescale", "-no-rescale",
                                  "-np 4 -norescale"])
def test_ignored_flags_match_jax(volume, flag):
    j, t = _both(volume, f"-gauss 1.5 {flag}", "np")
    _close(t, j)
    ref = mrc.read_mrc(str(volume / "np_torch.mrc")).data
    j0, t0 = _both(volume, "-gauss 1.5", "np0")
    np.testing.assert_array_equal(ref, t0)


@pytest.mark.parametrize("flag", ["-surface minima 3", "-planar minima 3",
                                  "-planar-tv 1", "-bs 10",
                                  "--membrane-normals-file f.ply"])
def test_renamed_flags_same_message(volume, flag):
    argv = f"-in {volume}/in.mrc -out {volume}/o.mrc {flag}".split()
    with pytest.raises(JInputError) as ej:
        JFM.run(argv)
    with pytest.raises(InputError) as et:
        TFM.run(argv, device="cpu")
    assert str(et.value) == str(ej.value)
    assert "renamed" in str(et.value) or "-bs" in str(et.value)
