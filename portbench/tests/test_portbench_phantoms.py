"""The benchmark's plain copy of the phantoms equals the port's
generator (``visfd_tpu_torch/utils/phantom.py``) on the CPU; the cells'
tiny tomograms are pinned by their bytes; a kind that is not built in
is found by its file (``traffic/kinds/``)."""

import hashlib

import numpy as np
import pytest
import torch

from portbench.harness import manifest, plain
from portbench.traffic import phantoms
from portbench.traffic.kinds import smoothed
from visfd_tpu_torch.utils import phantom as port

# sha256 of the float32 bytes of each cell's tiny tomogram (and mask),
# taken before kinds were found by file; torch's vectorised CPU kernels
# (AVX2 and AVX-512 alike) give these bits, its scalar ones others
PINNED = {
    ("membrane_tv.tomo268m", 1): (
        "e559e1782b9165ba7f829e2ba846926bebeee0ee15168d80380deb269890132f",
        None),
    ("membrane_tv.tomo268m", 2 ** 31 + 7): (
        "42321cb28d3e6834401ab6f1c7636e5c5908c89ae9bb0c0978834757546a3cbe",
        None),
    ("blob_ribosome.tomo268m", 1): (
        "ee2fa965fff25ce29f195f68c19c8d71f68c8874ec61fe686864b74599a5e5d1",
        "3d13b20e2c29a09a4d50cfe0fbe75a7de72f469cb915ca28f98a29b155e6c148"),
    ("blob_ribosome.tomo268m", 2 ** 31 + 7): (
        "c32d314996de072b55450470bd7f2cd52acd61f470a76011a26ed1d4ebbc181a",
        "3d13b20e2c29a09a4d50cfe0fbe75a7de72f469cb915ca28f98a29b155e6c148"),
}
CROWDED = {"kind": "blob", "n_blobs": 1500, "diameters_A": [160.0, 280.0],
           "noise": 0.3, "spacing": 32}


def _sha(t):
    return None if t is None else hashlib.sha256(
        t.numpy().tobytes()).hexdigest()


def _smoothed(of, sigma_a=40.0):
    return {"phantom": {"kind": "smoothed", "of": of, "sigma_A": sigma_a}}


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_membrane_equals_the_port_s(seed):
    shape = (20, 36, 28)
    got, gd = phantoms.membrane(shape, seed, 2.86, 0.3, 4, "cpu")
    want, wd = port.membrane_phantom(shape, seed=seed, thickness=2.86,
                                     noise=0.3, n_vesicles=4)
    assert torch.equal(got, want) and torch.equal(gd, wd)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 9])
def test_blob_equals_the_port_s(seed):
    shape = (48, 64, 96)
    got = phantoms.blob(shape, seed, 9, (8.16, 14.29), 0.3, 32, "cpu")
    want = port.blob_phantom(shape, seed=seed, n_blobs=9,
                             diameters=(8.16, 14.29), noise=0.3, spacing=32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert np.array_equal(got[2], want[2]) and np.array_equal(got[3],
                                                              want[3])


def test_same_seed_same_input():
    a, _ = phantoms.membrane((8, 16, 16), 7, 2.0, 0.3, 2, "cpu")
    b, _ = phantoms.membrane((8, 16, 16), 7, 2.0, 0.3, 2, "cpu")
    c, _ = phantoms.membrane((8, 16, 16), 8, 2.0, 0.3, 2, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("workload,seed", list(PINNED))
def test_cells_read_the_pinned_tomograms(workload, seed):
    cell = manifest.cell(workload)
    vol, mask = phantoms.make(cell.traffic, cell.traffic["tiny_zyx"],
                              cell.config["parameters"]["voxel_width_A"],
                              seed, "cpu")
    assert vol.dtype == torch.float32
    assert (_sha(vol), _sha(mask)) == PINNED[workload, seed]


@pytest.mark.parametrize("of,w", [(CROWDED, 19.6),
                                  ({"kind": "membrane", "thickness_A": 55.0,
                                    "noise": 0.3, "n_vesicles": 4}, 19.2)])
def test_smoothed_is_the_blur_of_its_phantom(of, w):
    """``smoothed`` is plain.blur3 of the wrapped phantom over its edge
    denominator, at -gauss's halfwidth, with the wrapped mask."""
    shape, seed = (48, 64, 64), 2 ** 31 + 3
    vol, mask = phantoms.make(_smoothed(of), shape, w, seed, "cpu")
    raw, raw_mask = phantoms.make({"phantom": of}, shape, w, seed, "cpu")
    sigma = 40.0 / w
    k = plain.gauss_kernel_1d(sigma, smoothed.halfwidth(sigma))
    want = plain.blur3(raw, k) / plain.edge_denominator(
        k, shape, torch.float32, "cpu")
    assert vol.dtype == torch.float32 and torch.equal(vol, want)
    assert (mask is None and raw_mask is None) or torch.equal(mask,
                                                              raw_mask)
    assert vol.std() < 0.5 * raw.std()


@pytest.mark.parametrize("sigma_a", [1.0, 19.6, 40.0, 58.8, 98.7, 200.0])
def test_smoothed_halfwidth_is_gauss_s(sigma_a, monkeypatch):
    """floor(sigma sqrt(-2 ln 0.03)), at least 1 (-gauss 40 at -w 19.6
    blurs over 5 voxels a side): the halfwidths the port's -gauss handler
    hands its blur at the CLI's default truncation, which the benchmark
    copies and does not import."""
    from visfd_tpu_torch.cli import filter_mrc, settings
    s = settings.parse_args(["-in", "a.mrc", "-out", "b.mrc", "-w", "19.6",
                             "-gauss", str(sigma_a)])
    s.width_a = [a / 19.6 for a in s.width_a]   # as run() rescales it
    seen = {}
    monkeypatch.setattr(filter_mrc.F, "apply_gauss",
                        lambda x, sigma, **kw: seen.update(kw))
    filter_mrc.handle_gauss(s, torch.zeros(1, 1, 1), None)
    assert seen["truncate_halfwidth"] == [
        smoothed.halfwidth(sigma_a / 19.6)] * 3
    assert smoothed.halfwidth(40.0 / 19.6) == 5


def test_smoothed_same_seed_same_volume():
    a, ma = phantoms.make(_smoothed(CROWDED), (48, 64, 64), 19.6, 7, "cpu")
    b, mb = phantoms.make(_smoothed(CROWDED), (48, 64, 64), 19.6, 7, "cpu")
    c, _ = phantoms.make(_smoothed(CROWDED), (48, 64, 64), 19.6, 8, "cpu")
    assert torch.equal(a, b) and torch.equal(ma, mb)
    assert not torch.equal(a, c)


def test_unknown_kind_is_named():
    with pytest.raises(ValueError, match="no phantom kind 'no_such'"):
        phantoms.make({"phantom": {"kind": "no_such"}}, (8, 8, 8), 1.0, 1,
                      "cpu")
