"""The readers' arithmetic on made-up request logs and traces, and each
roofline formula against the hand count of ``chip_smoke.bound_ms`` and
``chip_smoke.tv_work``."""

import math

import numpy as np
import pytest

from portbench import roofline
from portbench.harness import clock, manifest
from portbench.harness import trace as T
from portbench.harness.cell import Context


def _log(start, stages, end, spans=None):
    return clock.RequestLog(start, end, stages, spans or {}, {}, {})


def _ctx(requests, window, trace=None, workload="membrane_tv.tomo268m",
         shape=(256, 1024, 1024)):
    cell = manifest.cell(workload)
    return Context(cell.config, cell.traffic, shape, math.prod(shape),
                   requests, window, 12.5, 3 * 2 ** 30, 5 * 2 ** 30,
                   trace), cell


def test_stage_stream_timestamps_and_sums():
    s = clock.StageStream()
    s.write("---- read the tomogram ----\n")
    s.write("header line\n---- read the tomogram: 0.100s ----\n")
    s.write("---- draw spheres ----\n---- draw spheres: 0.2")
    s.write("00s ----\n")
    assert [n for n, _, _ in s.stages] == ["read the tomogram",
                                           "draw spheres"]
    log = _log(0.0, [("a", 1.0, 2.0), ("a", 3.0, 3.5), ("b", 1.5, 2.5)],
               5.0)
    assert log.stage_seconds("a") == 1.5
    assert log.staged_seconds() == pytest.approx(2.0)


def test_rate_and_stage_readers():
    reqs = [_log(10.0, [("read the tomogram", 10.0, 10.4),
                        ("copy the volume to the device", 10.5, 10.6),
                        ("write the tomogram", 10.7, 10.9)], 11.0),
            _log(11.0, [("read the tomogram", 11.0, 11.2),
                        ("copy the result to the host", 11.3, 11.4)], 12.0)]
    ctx, cell = _ctx(reqs, (10.0, 12.0))
    read = {m: cell.metric_reader(m).read for m in (
        "voxels_per_s", "mrc_read_s", "mrc_write_s", "host_device_copy_s",
        "host_unstaged_s", "card_peak_gib", "host_peak_gib", "setup_s",
        "membrane_stages_s", "blob_ladder_s", "device_idle_pct")}
    assert read["voxels_per_s"](ctx) == 2 * 256 * 1024 * 1024 / 2.0
    assert read["mrc_read_s"](ctx) == pytest.approx(0.3)
    assert read["mrc_write_s"](ctx) == pytest.approx(0.1)
    assert read["host_device_copy_s"](ctx) == pytest.approx(0.1)
    assert read["host_unstaged_s"](ctx) == pytest.approx(
        ((1.0 - 0.7) + (1.0 - 0.3)) / 2)
    assert read["card_peak_gib"](ctx) == 3.0
    assert read["host_peak_gib"](ctx) == 5.0
    assert read["setup_s"](ctx) == 12.5
    # what a cell has not got reads nothing, never 0
    assert read["membrane_stages_s"](ctx) is None
    assert read["blob_ladder_s"](ctx) is None
    assert read["device_idle_pct"](ctx) is None


def test_spans_and_idle_share():
    reqs = [_log(0.0, [("blob ladder + extrema + NMS", 0.1, 0.9)], 1.0,
                 {"blob: LoG ladder": 0.3, "blob: extremum test": 0.2,
                  "blob: compaction + copy": 0.1})]
    tr = T.DeviceTrace((0.0, 1.0), [("k1", 0.1, 0.3), ("k2", 0.2, 0.4),
                                    ("Memcpy HtoD", 0.8, 0.9)], 0.3)
    ctx, cell = _ctx(reqs, (0.0, 1.0), tr, "blob_ribosome.tomo268m")
    assert cell.metric_reader("blob_ladder_s").read(ctx) == 0.3
    assert cell.metric_reader("blob_extremum_s").read(ctx) == \
        pytest.approx(0.3)
    assert cell.metric_reader("device_idle_pct").read(ctx) == \
        pytest.approx(70.0)
    assert T.union_seconds([(0.1, 0.3), (0.2, 0.4), (0.8, 0.9)]) == \
        pytest.approx(0.4)
    b = T.breakdown(tr, reqs)
    idle = dict(b["idle_gaps"])
    assert idle["blob ladder + extrema + NMS"] == pytest.approx(0.8 - 0.4)
    assert idle["unstaged"] == pytest.approx(0.1 + 0.1)
    assert sum(idle.values()) == pytest.approx(1.0 - 0.4)
    assert dict(b["device_ops"])["k1"] == pytest.approx(0.2)
    assert T.short_name("void (anonymous namespace)::tv_votes_kernel<4, "
                        "false>(float const*, int)") == \
        "tv_votes_kernel<4, false>"


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(manifest.ROOT, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_peaks_are_chip_smoke_s():
    cs = _chip_smoke()
    p = roofline.peaks()
    assert p["hbm_bytes_per_s"] == cs.HBM_BYTES_PER_S
    assert p["fp32_ops_per_s"] == cs.FP32_OPS_PER_S
    for nbytes, nops in ((1e9, 1e9), (1e6, 1e12)):
        assert roofline.bound_s(nbytes, nops) * 1e3 == pytest.approx(
            cs.bound_ms(nbytes, nops)[0])


def test_hessian_and_tv_work_against_chip_smoke():
    import torch
    cs = _chip_smoke()
    ctx, _ = _ctx([], (0.0, 1.0), shape=(16, 32, 32))
    n = 8 * 16 * 16
    nbytes, nops = roofline.kernel("hessian_eigen").work(ctx)
    assert (nbytes, nops) == (20 * n, (cs.HESSIAN_OPS
                                       + cs.SCORE_OPS["planar"]) * n)
    # chip_smoke's count of the same vote: the -tv-best field's non-zero
    # sources (floor(n f) + 1 where no scores tie) times its taps
    p = ctx.config["parameters"]
    sigma = 4 * 55 / math.sqrt(3) / 38.4
    sal = torch.zeros(n)
    sal[:int(math.floor(n * p["tv_best"])) + 1] = 1.0
    want = cs.tv_work(sal, n, n, 4, p["tv_truncate_ratio"], sigma, False)
    assert roofline.kernel("tv_sparse").work(ctx) == want


def test_blur3_work_by_hand():
    from portbench.references import blob_ribosome as R
    ctx, _ = _ctx([], (0.0, 1.0), workload="blob_ribosome.tomo268m")
    p = ctx.config["parameters"]
    sig = R.sigmas(p)
    assert len(sig) == 58
    from visfd_tpu_torch.ops.filters import log_halfwidths
    hws = [R.log_halfwidth(s, p) for s in sig]
    tr = math.sqrt(-2 * math.log(p["filter_truncate_threshold"]))
    assert hws == [log_halfwidths(s, p["delta_sigma_over_sigma"], tr)[2][0]
                   for s in sig]
    assert (min(hws), max(hws)) == (6, 10)
    n = 256 * 1024 * 1024
    cs = _chip_smoke()
    want_ops = sum(4 * cs.BLUR_OPS_PER_TAP * 3 * (2 * h + 1) * n
                   for h in hws)
    assert roofline.kernel("blur3").work(ctx) == (58 * 4 * 8 * n, want_ops)
    assert roofline.kernel("blur3").LAUNCHES(ctx) == 232


def test_share_needs_the_requests_launches():
    reqs = [_log(0.0, [], 1.0), _log(1.0, [], 2.0)]
    tr = T.DeviceTrace((0.0, 2.0), [("hessian_principal_kernel<0>", 0.1,
                                     0.1 + 1e-3),
                                    ("hessian_principal_kernel<0>", 1.1,
                                     1.1 + 1e-3)], 2e-3)
    ctx, cell = _ctx(reqs, (0.0, 2.0), tr)
    nbytes, nops = roofline.kernel("hessian_eigen").work(ctx)
    got = cell.metric_reader("roofline.hessian_eigen").read(ctx)
    assert got == pytest.approx(100 * 2 * roofline.bound_s(nbytes, nops)
                                / 2e-3)
    tr.ops.pop()
    assert cell.metric_reader("roofline.hessian_eigen").read(ctx) is None
    assert np.isfinite(got)
