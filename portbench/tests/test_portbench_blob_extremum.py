"""The blob extremum kernel's roofline formula against the hand count of
its bytes and ``chip_smoke``'s count of its operations."""

import dataclasses

from portbench import roofline
from portbench.tests.test_portbench_metrics import _chip_smoke, _ctx


def test_blob_extremum_work_by_hand():
    ctx, _ = _ctx([], (0.0, 1.0), workload="blob_ribosome.tomo268m")
    k = roofline.kernel("blob_extremum")
    n = 256 * 1024 * 1024
    assert k.LAUNCHES(ctx) == 56
    # three float32 scales and the mask's byte a voxel, each mid scale;
    # the operations as chip_smoke counts them
    assert _chip_smoke().BLOB_EXTREMUM_OPS == 48
    assert k.work(ctx) == (13 * n * 56, 48 * n * 56)
    argv = ctx.config["argv"]
    i = argv.index("-mask")
    unmasked = dataclasses.replace(ctx, config=dict(
        ctx.config, argv=argv[:i] + argv[i + 2:]))
    assert k.work(unmasked) == (12 * n * 56, 48 * n * 56)
    # the bytes bind
    nbytes, nops = k.work(ctx)
    p = roofline.peaks()
    assert nbytes / p["hbm_bytes_per_s"] > nops / p["fp32_ops_per_s"]
