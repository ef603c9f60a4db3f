"""The launch plan of the dense-correlation kernel (``csrc/conv3d.cu``),
chosen on the host by ``ops/dense_cuda.dense_plan``: it fits Hopper's
227 KB of shared memory a block, takes the compiled instance for every
kernel shape the CLI builds for the dense filters, and a runtime plan
for every other odd shape.  Pure host code: no card needed."""

import numpy as np
import pytest
import torch

from visfd_tpu_torch.cli import filter_mrc as FM
from visfd_tpu_torch.cli import settings as S
from visfd_tpu_torch.ops import conv
from visfd_tpu_torch.ops import dense_cuda as DC


def _smem_bytes(kshape, plan):
    """The shared memory the kernel addresses under ``plan``: the padded
    taps (when staged) and the ring of units, each (8 + band - 1) rows
    of 128 + wxp floats (csrc/conv3d.cu's tile: 8 rows, 128 columns)."""
    wz, wy, wx = kshape
    wxp = -(-wx // 4) * 4
    taps = wz * wy * wxp if plan.smem_taps else 0
    return 4 * (taps + plan.stages * (8 + plan.band - 1) * (128 + wxp))


def _check_plan(kshape, plan):
    assert plan is not None
    assert plan.smem == _smem_bytes(kshape, plan) <= DC.SMEM_LIMIT
    assert plan.stages in (2, 3) and 1 <= plan.band <= kshape[1]


@pytest.mark.parametrize("args", ["-ggauss 2", "-dogg 2 4",
                                  "-fluct 3 -exponent 3", "-doggxy 2 4 2",
                                  "-template-gauss 3 6"])
def test_cli_dense_kernels_take_compiled_instances(monkeypatch, args):
    """Every kernel the handler hands the dense kernel (recorded where
    ops.conv calls it) has a compiled instance, with its whole padded
    kernel and three units in shared memory."""
    seen = []
    real = conv.conv3d_dense

    def record(x, kflip):
        seen.append(tuple(kflip.shape))
        return real(x, kflip)
    monkeypatch.setattr(conv, "conv3d_dense", record)
    s = S.parse_args(f"-in a.rec -out b.rec -w 1 {args}".split())
    handler = {"-ggauss": FM.handle_ggauss, "-dogg": FM.handle_dogg,
               "-fluct": FM.handle_fluct,
               "-template-gauss": FM.handle_template_gauss,
               "-doggxy": FM.handle_doggxy}[args.split()[0]]
    rng = np.random.default_rng(3)
    handler(s, torch.tensor(rng.normal(size=(4, 5, 6)).astype(np.float32)),
            None)
    assert seen
    for kshape in seen:
        plan = DC.dense_plan(kshape)
        _check_plan(kshape, plan)
        assert plan.variant == DC.COMPILED[kshape][0] > 0
        assert plan.smem_taps and plan.stages == 3
        assert plan.band == kshape[1]


@pytest.mark.parametrize("kshape", [(1, 1, 1), (9, 9, 9), (11, 11, 11),
                                    (13, 13, 13), (21, 21, 21),
                                    (33, 33, 33), (41, 41, 41),
                                    (61, 61, 61), (3, 61, 1), (1, 3, 5),
                                    (5, 1, 1), (1, 1, 241), (1, 241, 1),
                                    (241, 1, 1), (1, 241, 241),
                                    (61, 1, 241)])
def test_runtime_plan_fits(kshape):
    """Other odd shapes up to (61, 61, 61) and (1, 1, 241), and beyond:
    the runtime instance, within 227 KB; taps through L1 only where
    they do not fit beside two units, bands of kernel rows only where a
    whole kernel's rows do not fit in two units."""
    plan = DC.dense_plan(kshape)
    _check_plan(kshape, plan)
    assert plan.variant == 0
    wz, wy, wx = kshape
    wxp = -(-wx // 4) * 4
    unit = 4 * (8 + wy - 1) * (128 + wxp)
    if 4 * wz * wy * wxp + 2 * unit <= DC.SMEM_LIMIT:
        assert plan.smem_taps
    if 2 * unit <= DC.SMEM_LIMIT:
        assert plan.band == wy


def test_no_plan_for_a_row_wider_than_shared_memory():
    """A kernel row of 7001 taps leaves no room for two units of one
    row: no plan, and the wrapper would raise on the card."""
    assert DC.dense_plan((1, 1, 7001)) is None
    assert DC.dense_plan((1, 1, 3001)) is not None
