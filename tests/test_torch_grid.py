"""The port's ``VoxelGrid`` (``visfd_tpu_torch.core.grid``) against the
JAX package's (``visfd_tpu.core.grid``): ``from_numpy`` with a scalar
and a tuple voxel width, with a mask, whole and split over a CPU mesh;
``shape``; ``to_numpy``.  Both hold float32 copies of the same input,
so every array is compared bit for bit."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import visfd_tpu
import visfd_tpu_torch
from visfd_tpu.parallel.mesh import grid_sharding, make_mesh as jax_mesh
from visfd_tpu_torch.core.grid import VoxelGrid
from visfd_tpu_torch.parallel.mesh import ShardedVolume, make_mesh

SHAPE = (8, 12, 20)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(21)
    data = rng.normal(size=SHAPE)                  # float64: both cast
    mask = (rng.uniform(size=SHAPE) > 0.3).astype(np.float64)
    return data, mask


def test_the_package_exports_it():
    assert visfd_tpu_torch.VoxelGrid is VoxelGrid
    assert visfd_tpu.VoxelGrid.__name__ == "VoxelGrid"


@pytest.mark.parametrize("width", [1.0, 2.5, (1.0, 2.0, 3.0)])
@pytest.mark.parametrize("masked", [False, True])
def test_from_numpy_matches_jax(arrays, width, masked):
    data, mask = arrays
    m = mask if masked else None
    want = visfd_tpu.VoxelGrid.from_numpy(data, voxel_width=width, mask=m)
    got = VoxelGrid.from_numpy(data, voxel_width=width, mask=m,
                               device="cpu")
    assert got.shape == want.shape == SHAPE
    assert got.voxel_width == want.voxel_width
    assert got.data.dtype == torch.float32
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    if masked:
        np.testing.assert_array_equal(got.mask.numpy(),
                                      np.asarray(want.mask))
    else:
        assert got.mask is None and want.mask is None


@pytest.mark.parametrize("n", [4, 8])
def test_from_numpy_on_a_mesh_matches_jax(arrays, n):
    """``mesh`` splits data and mask into the mesh's (z, y) blocks, as
    the JAX class's ``sharding``."""
    data, mask = arrays
    jm = jax_mesh(n)
    want = visfd_tpu.VoxelGrid.from_numpy(data, 2.0, mask=mask,
                                          sharding=grid_sharding(jm))
    mesh = make_mesh(n, devices=["cpu"] * n)
    got = VoxelGrid.from_numpy(data, 2.0, mask=mask, mesh=mesh)
    assert isinstance(got.data, ShardedVolume) and got.data.mesh == mesh
    assert isinstance(got.mask, ShardedVolume)
    assert got.data.mesh.shape == tuple(jm.devices.shape)
    assert got.shape == want.shape == SHAPE
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    bz, by = got.data.block_shape
    for iz, iy, b in got.mask.cells():
        np.testing.assert_array_equal(
            b.numpy(), np.asarray(want.mask)[iz * bz:(iz + 1) * bz,
                                             iy * by:(iy + 1) * by])


def test_new_modules_never_import_jax():
    """Importing the checkpoint and the grid leaves jax and the JAX
    package out of a fresh interpreter."""
    code = ("import sys\n"
            "import visfd_tpu_torch.io.checkpoint, visfd_tpu_torch.core.grid\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'visfd_tpu'))\n"
            "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
