"""The benchmark's plain copy of the phantoms equals the port's
generator (``visfd_tpu_torch/utils/phantom.py``) on the CPU."""

import numpy as np
import pytest
import torch

from portbench.traffic import phantoms
from visfd_tpu_torch.utils import phantom as port


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
