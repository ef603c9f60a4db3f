"""The readers of the program's tracing stages, spans and byte counters
on made-up request logs: each the mean a tomogram over the window's
requests, and None where no request has what it reads (a program
without those stages and counters)."""

import math

import pytest

from portbench.harness import clock, manifest
from portbench.harness.cell import Context

GIB = 2 ** 30


def _log(start, end, stages=(), spans=None, counts=None):
    return clock.RequestLog(start, end, list(stages), spans or {}, {},
                            counts or {})


def _ctx(requests, workload):
    cell = manifest.cell(workload)
    shape = (256, 1024, 1024)
    return Context(cell.config, cell.traffic, shape, math.prod(shape),
                   requests, (requests[0].start, requests[-1].end), 12.5,
                   0, 0, None), cell


MEMBRANE = [
    _log(0.0, 1.0, [("read the tomogram", 0.0, 0.4),
                    ("bin the tomogram", 0.4, 0.6),
                    ("write the tomogram", 0.8, 0.95)],
         {"mrc: header statistics": 0.1},
         {"bytes to the device": 9 * GIB // 8,
          "bytes to the host": GIB // 4}),
    _log(1.0, 2.0, [("read the tomogram", 1.0, 1.4),
                    ("bin the tomogram", 1.4, 1.7),
                    ("write the tomogram", 1.8, 1.95)],
         {"mrc: header statistics": 0.05},
         {"bytes to the device": 9 * GIB // 8,
          "bytes to the host": GIB // 4}),
]
BLOB = [
    _log(0.0, 11.0, [("read the tomogram", 0.0, 0.4),
                     ("read the mask", 0.4, 0.8),
                     ("blob ladder + extrema + NMS", 1.0, 8.0),
                     ("write the blob lists", 8.0, 9.0),
                     ("draw spheres", 9.0, 10.5)],
         {"blob: LoG ladder": 2.5},
         {"bytes to the device": 4 * GIB, "bytes to the host": 3 << 20}),
]


@pytest.mark.parametrize("workload,requests,want", [
    ("membrane_tv.tomo268m", MEMBRANE,
     {"binning_s": 0.25, "mrc_write_stats_s": 0.075,
      "host_to_device_gib": 1.125, "device_to_host_gib": 0.25,
      "mask_read_s": None, "blob_list_write_s": None}),
    ("blob_ribosome.tomo268m", BLOB,
     {"mask_read_s": 0.4, "blob_list_write_s": 1.0,
      "host_to_device_gib": 4.0, "device_to_host_gib": 3 / 1024,
      "binning_s": None, "mrc_write_stats_s": None}),
], ids=["membrane", "blob"])
def test_tracing_readers(workload, requests, want):
    ctx, cell = _ctx(requests, workload)
    for name, value in want.items():
        got = cell.metric_reader(name).read(ctx)
        if value is None:
            assert got is None, name
        else:
            assert got == pytest.approx(value), name


@pytest.mark.parametrize("name", [
    "binning_s", "mask_read_s", "blob_list_write_s", "mrc_write_stats_s",
    "host_to_device_gib", "device_to_host_gib"])
def test_a_parent_without_the_tracing_reads_nothing(name):
    """The stages, spans and counters of the program before them: every
    reader returns None and raises nothing."""
    reqs = [_log(0.0, 1.0, [("read the tomogram", 0.0, 0.5)],
                 {"blob: LoG ladder": 0.2}, {"blob minima": 306000})]
    ctx, cell = _ctx(reqs, "blob_ribosome.tomo268m")
    assert cell.metric_reader(name).read(ctx) is None


def test_a_count_missing_from_some_requests_counts_zero_there():
    reqs = [_log(0.0, 1.0, counts={"bytes to the device": GIB}),
            _log(1.0, 2.0)]
    ctx, cell = _ctx(reqs, "membrane_tv.tomo268m")
    assert cell.metric_reader("host_to_device_gib").read(ctx) == 0.5
    assert cell.metric_reader("device_to_host_gib").read(ctx) is None


def test_every_new_metric_is_in_its_cells():
    for workload, names in (
            ("membrane_tv.tomo268m", {"binning_s", "mrc_write_stats_s",
                                      "host_to_device_gib",
                                      "device_to_host_gib"}),
            ("blob_ribosome.tomo268m", {"mask_read_s", "blob_list_write_s",
                                        "host_to_device_gib",
                                        "device_to_host_gib"})):
        per = {m["name"] for m in manifest.cell(workload).per_layer}
        assert names <= per
