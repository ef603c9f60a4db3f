"""The PyTorch port's package boundary: it never imports jax, its filter
tables equal the JAX package's bit for bit, and convert.py round-trips
both field layouts."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visfd_tpu.features import tv as JTV
from visfd_tpu.ops import kernels as JK
from visfd_tpu_torch.convert import to_numpy, to_torch
from visfd_tpu_torch.ops import kernels as TK
from visfd_tpu_torch.ops.tv_cuda import tv_tables

SLICE_MODULES = [
    "visfd_tpu_torch", "visfd_tpu_torch._cuda_build",
    "visfd_tpu_torch.convert", "visfd_tpu_torch.io",
    "visfd_tpu_torch.io.mrc", "visfd_tpu_torch.io.coords",
    "visfd_tpu_torch.ops.kernels", "visfd_tpu_torch.ops.conv",
    "visfd_tpu_torch.ops.blur_cuda", "visfd_tpu_torch.ops.filters",
    "visfd_tpu_torch.ops.resample", "visfd_tpu_torch.ops.eigen_cuda",
    "visfd_tpu_torch.ops.tv_cuda", "visfd_tpu_torch.linalg.sym3",
    "visfd_tpu_torch.features.hessian", "visfd_tpu_torch.features.tv",
    "visfd_tpu_torch.parallel.reduce", "visfd_tpu_torch.parallel.mesh",
    "visfd_tpu_torch.parallel.halo", "visfd_tpu_torch.parallel.gather",
    "visfd_tpu_torch.parallel.sharded", "visfd_tpu_torch.utils",
    "visfd_tpu_torch.utils.progress", "visfd_tpu_torch.utils.phantom",
    "visfd_tpu_torch.cli.settings",
    "visfd_tpu_torch.cli.filter_mrc",
    "visfd_tpu_torch.native", "visfd_tpu_torch.io.pointcloud",
    "visfd_tpu_torch.segment", "visfd_tpu_torch.segment.extrema",
    "visfd_tpu_torch.segment.connect", "visfd_tpu_torch.segment.watershed",
    "visfd_tpu_torch.segment.propagate",
    "visfd_tpu_torch.parallel.sharded_features",
    "visfd_tpu_torch.parallel.blocks",
    "visfd_tpu_torch.ops.threshold", "visfd_tpu_torch.ops.draw",
    "visfd_tpu_torch.features.blob", "visfd_tpu_torch.features.supervised",
    "visfd_tpu_torch.ops.morphology", "visfd_tpu_torch.ops.dense_cuda",
    "visfd_tpu_torch.ops.filter2d", "visfd_tpu_torch.features.experimental",
    "visfd_tpu_torch.cli.combine_mrc", "visfd_tpu_torch.cli.sum_voxels",
    "visfd_tpu_torch.cli.pval_mrc", "visfd_tpu_torch.cli.crop_mrc",
    "visfd_tpu_torch.cli.convert_to_float",
    "visfd_tpu_torch.cli.print_mrc_stats",
    "visfd_tpu_torch.cli.histogram_mrc", "visfd_tpu_torch.cli.voxelize_mesh",
    "visfd_tpu_torch.cli.draw_filter_1d",
    "visfd_tpu_torch.parallel.distributed", "visfd_tpu_torch.entry",
    "visfd_tpu_torch.utils.profiling", "visfd_tpu_torch.io.checkpoint",
    "visfd_tpu_torch.core", "visfd_tpu_torch.core.grid",
    # the card's script and tests, run where jax is absent
    "chip_smoke", "tests.test_torch_cuda_kernels",
]


def test_port_never_imports_jax():
    """In a fresh interpreter (this one already imported jax through
    tests/conftest.py), importing every module of the port, chip_smoke.py
    and the card's test file leaves jax and the JAX package out of
    sys.modules."""
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'visfd_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("tool", ["print_mrc_stats", "histogram_mrc",
                                  "convert_to_float", "crop_mrc",
                                  "draw_filter_1d", "voxelize_mesh"])
def test_host_tools_start_without_torch(tool):
    """The host-only tools import numpy and io/mrc alone: the package's
    VoxelGrid export is lazy, so torch stays out of sys.modules until a
    caller asks for it."""
    code = (f"import sys, visfd_tpu_torch.cli.{tool}\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("sigma,hw", [(0.0, 0), (1.2, 3), (2.5, 6),
                                      (12.0, 30)])
def test_gauss_kernel_1d_bit_identical(sigma, hw):
    np.testing.assert_array_equal(TK.gauss_kernel_1d(sigma, hw),
                                  JK.gauss_kernel_1d(sigma, hw))


@pytest.mark.parametrize("sigma,ratio", [(1.5, np.sqrt(2.0)),
                                         (2.12133, np.sqrt(2.0)),
                                         (0.9, 2.5)])
def test_tv_tables_bit_identical(sigma, ratio):
    np.testing.assert_array_equal(
        TK.gen_gauss_kernel_3d((sigma,) * 3, 2.0, (3, 3, 3)),
        JK.gen_gauss_kernel_3d((sigma,) * 3, 2.0, (3, 3, 3)))
    w, rhat, hw = tv_tables(sigma, ratio)
    w_j, rhat_j, _, hw_j = JTV.tv_tables(sigma, ratio)
    assert hw == hw_j
    for got, want in ((w, w_j), (rhat, rhat_j)):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)


def test_convert_round_trips_both_layouts():
    rng = np.random.default_rng(0)
    vol = rng.normal(size=(4, 5, 6)).astype(np.float32)
    field = rng.normal(size=(4, 5, 6, 3)).astype(np.float32)
    t = to_torch(vol)
    assert t.dtype == torch.float32 and t.shape == (4, 5, 6)
    np.testing.assert_array_equal(to_numpy(t), vol)
    cm = to_torch(field, channels_last=True)
    assert cm.shape == (3, 4, 5, 6) and cm.is_contiguous()
    np.testing.assert_array_equal(to_numpy(cm[1]), field[..., 1])
    np.testing.assert_array_equal(to_numpy(cm, channels_last=True), field)
    # a JAX channel-last result lands in the port's channel-major layout
    j = jnp.asarray(field)
    np.testing.assert_array_equal(
        to_numpy(to_torch(np.asarray(j), channels_last=True)[2]),
        np.asarray(j[..., 2]))


@pytest.mark.parametrize("module", ["features.hessian", "linalg.sym3",
                                    "features.experimental", "ops.filter2d",
                                    "ops.conv"])
def test_public_functions_ported(module):
    """Every public function of the JAX module has a counterpart of the
    same name in the port's."""
    import importlib
    import inspect
    jm = importlib.import_module(f"visfd_tpu.{module}")
    tm = importlib.import_module(f"visfd_tpu_torch.{module}")
    # callables defined in the module (jitted ones included), no classes
    names = {n for n, f in vars(jm).items()
             if callable(f) and not inspect.isclass(f)
             and not n.startswith("_")
             and getattr(f, "__module__", None) == jm.__name__}
    if module == "ops.conv":
        names &= {"conv1d_axis", "dense_conv3d", "separable_conv3d"}
    missing = sorted(n for n in names if not hasattr(tm, n))
    assert names and not missing, missing


def test_every_cli_tool_has_a_counterpart():
    """Each tool of visfd_tpu/cli has a module in visfd_tpu_torch/cli with
    run() and main()."""
    import importlib
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent
    tools = sorted(p.stem for p in (root / "visfd_tpu" / "cli").glob("*.py")
                   if p.stem not in ("__init__", "settings"))
    assert len(tools) == 10
    for t in tools:
        m = importlib.import_module(f"visfd_tpu_torch.cli.{t}")
        assert callable(m.run) and callable(m.main), t
