"""The port's tracing (``utils/progress``) and its counted copies
(``utils/transfer``): stages that repeat add up, every stage and span is
a ``record_function`` annotation while a profiler records (and only
then), the annotations nest as the blocks do, ``to_device`` and
``to_host`` count only what crosses, and the host<->device byte counters
of ``filter_mrc`` commands equal the sums worked out from their shapes.

On the CPU no byte crosses between host and device, so the counter
cases count the copies with numpy arrays as the host side and tensors
as the device side (``transfer._on_host`` patched); the call sites and
the arithmetic are those of a run on a card."""

import contextlib
import io
import json
import warnings

import numpy as np
import pytest
import torch

from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.parallel.gather import to_host_np
from visfd_tpu_torch.utils import progress as P
from visfd_tpu_torch.utils import transfer as X
from visfd_tpu_torch.utils.phantom import blob_phantom, membrane_phantom
from visfd_tpu_torch.utils.profiling import device_trace

BLOB_SHAPE = (24, 32, 40)
MEMBRANE_SHAPE = (16, 24, 32)
F32 = 4

# command name -> (argv with {d} for the directory, the input's shape,
# the stages it must open, (span, the stage that encloses it) pairs)
COMMANDS = {
    "blob": ("-in {d}/blob.mrc -mask {d}/blob_mask.mrc -w 19.6 "
             "-blob minima {d}/minima.txt 160 200 1.05",
             BLOB_SHAPE,
             ["read the tomogram", "read the mask",
              "copy the volume to the device",
              "blob ladder + extrema + NMS", "write the blob lists",
              "draw spheres"],
             [("blob: LoG ladder", "blob ladder + extrema + NMS"),
              ("blob: extremum test", "blob ladder + extrema + NMS"),
              ("blob: compaction + copy", "blob ladder + extrema + NMS"),
              ("blob: candidate merge", "blob ladder + extrema + NMS")]),
    "membrane": ("-in {d}/membrane.mrc -out {d}/out.mrc -w 19.2 "
                 "-membrane minima 55 -tv 4 -tv-angle-exponent 4 -bin 2",
                 MEMBRANE_SHAPE,
                 ["read the tomogram", "bin the tomogram",
                  "copy the volume to the device",
                  "dense stick tensor voting",
                  "copy the result to the host", "write the tomogram"],
                 [("mrc: header statistics", "write the tomogram")]),
    "membrane_masked": ("-in {d}/membrane.mrc -mask {d}/membrane_mask.mrc "
                        "-out {d}/out.mrc -w 19.2 -membrane minima 55 -tv 4 "
                        "-bin 2",
                        MEMBRANE_SHAPE,
                        ["read the mask", "bin the tomogram"],
                        [("mrc: header statistics", "write the tomogram")]),
    "gauss": ("-in {d}/membrane.mrc -out {d}/out.mrc -w 1 -gauss 2",
              MEMBRANE_SHAPE,
              ["read the tomogram", "copy the volume to the device",
               "filter gauss", "copy the result to the host",
               "write the tomogram"],
              [("mrc: header statistics", "write the tomogram")]),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing")
    vol, mask, _, _ = blob_phantom(BLOB_SHAPE, seed=5, n_blobs=6,
                                   spacing=16, diameters=(8.0, 10.0))
    mrc.write_mrc(str(d / "blob.mrc"), vol.numpy())
    mrc.write_mrc(str(d / "blob_mask.mrc"), mask.numpy())
    vol, _ = membrane_phantom(MEMBRANE_SHAPE, seed=3)
    mrc.write_mrc(str(d / "membrane.mrc"), vol.numpy())
    mask = np.zeros(MEMBRANE_SHAPE, np.float32)
    mask[2:-2] = 1.0
    mrc.write_mrc(str(d / "membrane_mask.mrc"), mask)
    return d


def _run(argv, rep):
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        assert TFM.run(argv, device="cpu", report=rep) == 0, \
            buf.getvalue()[-2000:]


def _argv(name, d):
    return COMMANDS[name][0].format(d=d).split()


def test_a_repeated_stage_adds_up():
    out = io.StringIO()
    rep = P.Report(out)
    for _ in range(2):
        with P.stage("twice", rep):
            torch.ones(8).sum()
    ends = [float(line.split(": ")[1][:-len("s ----")])
            for line in out.getvalue().splitlines()
            if line.startswith("---- twice: ")]
    assert len(ends) == 2
    assert rep.timings["twice"] == pytest.approx(sum(ends), abs=2e-3)
    assert rep.timings["twice"] > max(ends) - 1e-3


def test_counts_add_silently_and_record_count_sets():
    out = io.StringIO()
    rep = P.Report(out)
    rep.add_count(P.TO_DEVICE, 3)
    rep.add_count(P.TO_DEVICE, 4)
    assert rep.counts[P.TO_DEVICE] == 7 and out.getvalue() == ""
    rep.record_count("blob minima", 5)
    rep.record_count("blob minima", 2)
    assert rep.counts["blob minima"] == 2
    assert out.getvalue() == "blob minima: 5\nblob minima: 2\n"
    assert rep.format_copies() == ("host<->device bytes: 7 to the device, "
                                   "0 to the host")


def _as_device(monkeypatch):
    """Tensors as the device side, numpy arrays as the host side."""
    monkeypatch.setattr(X, "_on_host",
                        lambda a: not isinstance(a, torch.Tensor))


# copies that stay on the host (the CPU is the host): nothing counted
HOST_TO_HOST = {
    "numpy-to-cpu": lambda rep: X.to_device(np.zeros(4, np.float32), "cpu",
                                            rep),
    "cpu-to-numpy": lambda rep: X.to_host(torch.zeros(4), rep),
    "cpu-to-cpu": lambda rep: X.to_device(
        torch.zeros(4, dtype=torch.float64), "cpu", rep, torch.float32),
    "numpy-to-numpy": lambda rep: X.to_host(np.zeros(4, np.float32), rep,
                                            np.float64),
}


@pytest.mark.parametrize("name", sorted(HOST_TO_HOST))
def test_a_copy_on_the_host_counts_nothing(name):
    rep = P.Report(None)
    HOST_TO_HOST[name](rep)
    HOST_TO_HOST[name](None)           # no Report: nothing, no error
    assert rep.counts == {}


# (a copy, with tensors as the device side, and the counts it makes)
CROSSINGS = {
    # the destination's bytes: 10 uint8 land as 10 float32
    "up-as-float32": (lambda rep: X.to_device(
        np.zeros(10, np.uint8), "cpu", rep, torch.float32),
        {P.TO_DEVICE: 40}),
    "down": (lambda rep: X.to_host(torch.zeros(3, dtype=torch.int64), rep),
             {P.TO_HOST: 24}),
    # a z slab into its place in a host tensor: the slab's bytes
    "down-into-place": (lambda rep: X.to_host(
        torch.zeros(2, 3), rep, out=torch.empty(4, 3)[:2]),
        {P.TO_HOST: 24}),
    "device-to-device": (lambda rep: X.to_device(torch.zeros(3), "cpu", rep),
                         {}),
}


@pytest.mark.parametrize("name", sorted(CROSSINGS))
def test_a_crossing_counts_the_destination_bytes(name, monkeypatch):
    _as_device(monkeypatch)
    copy, want = CROSSINGS[name]
    rep = P.Report(None)
    copy(rep)
    assert rep.counts == want


@pytest.mark.parametrize("dtype", [None, torch.float64])
def test_a_read_only_buffer_uploads_without_a_warning(dtype):
    # an MRC volume is a read-only view of the file's bytes
    raw = np.arange(24, dtype=np.float32).tobytes()
    a = np.frombuffer(raw, np.float32).reshape(2, 3, 4)
    assert not a.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = X.to_device(a, "cpu", dtype=dtype)
    t += 1                              # a fresh copy: the buffer stays
    np.testing.assert_array_equal(a.ravel(), np.arange(24))
    assert t.dtype == (dtype or torch.float32)


@pytest.mark.parametrize("way", ["to_device", "to_host"])
def test_dtype_converts(way, monkeypatch):
    _as_device(monkeypatch)
    rep = P.Report(None)
    if way == "to_device":
        got = X.to_device(np.arange(3, dtype=np.int16), "cpu", rep,
                          torch.float32)
        assert got.dtype == torch.float32 and got.tolist() == [0, 1, 2]
        assert rep.counts == {P.TO_DEVICE: 12}
    else:
        got = X.to_host(torch.arange(3, dtype=torch.int32), rep, np.float64)
        assert got.dtype == np.float64 and got.tolist() == [0, 1, 2]
        # the bytes that crossed, before the host converts them
        assert rep.counts == {P.TO_HOST: 12}


def test_no_profiler_enters_no_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    rep = P.Report(None)
    with P.stage("a stage", rep):
        with P.span("a span", rep):
            pass
    with P.span("no report", None):
        pass
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with P.stage("a stage", rep):
            with P.span("a span", rep):
                pass
    assert entered == ["a stage", "a span"]


def _annotations(trace_path):
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and "dur" in e:
            out.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


@pytest.mark.parametrize("name", ["blob", "membrane"])
def test_trace_shows_every_stage_and_nests_the_spans(name, inputs,
                                                      tmp_path):
    _, _, stages, nested = COMMANDS[name]
    rep = P.Report(None)
    with device_trace(str(tmp_path / "trace")) as prof:
        _run(_argv(name, inputs), rep)
    ann = _annotations(prof.trace_path)
    for st in stages:
        assert st in ann, (st, sorted(ann))
    for sp, parent in nested:
        assert sp in ann, (sp, sorted(ann))
        for t0, t1 in ann[sp]:
            assert any(p0 <= t0 and t1 <= p1 for p0, p1 in ann[parent]), \
                (sp, parent)
    # each stage's annotation covers its clock's seconds
    for st in stages:
        traced = sum(t1 - t0 for t0, t1 in ann[st]) * 1e-6
        assert traced == pytest.approx(rep.timings[st], rel=0.2, abs=0.01)


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_byte_counters_equal_the_shapes_sums(name, inputs, monkeypatch):
    _as_device(monkeypatch)
    out = io.StringIO()
    rep = P.Report(out)
    _run(_argv(name, inputs), rep)
    shape = COMMANDS[name][1]
    full = int(np.prod(shape)) * F32
    binned = int(np.prod([n // 2 for n in shape])) * F32
    up, down = rep.counts[P.TO_DEVICE], rep.counts.get(P.TO_HOST, 0)
    if name == "blob":
        # the volume and the mask, once to the ladder and once more to
        # the drawing; back come only the candidates, two int64 each
        # (the flat index with the kind, the score's bits), of which the
        # lists keep some
        assert up == 4 * full
        kept = rep.counts["blob minima"] + rep.counts["blob maxima"]
        assert down > 0 and down % (2 * 8) == 0 and down >= 16 * kept
    elif name == "gauss":
        # the volume up; the filtered volume down in "copy the result to
        # the host"
        assert up == down == full
    else:
        # binning: the volume up, the binned volume down; the binned
        # volume up again, the score down
        per = 2 if name == "membrane_masked" else 1
        assert up == per * (full + binned)
        assert down == (per + 1) * binned
    assert out.getvalue().splitlines()[-1] == (
        f"host<->device bytes: {up} to the device, {down} to the host")
    for st in COMMANDS[name][2]:
        assert st in rep.timings, (st, sorted(rep.timings))


def test_shard_and_to_host_np_count_their_copies(monkeypatch):
    from visfd_tpu_torch.parallel.mesh import make_mesh, shard
    _as_device(monkeypatch)
    x = np.arange(8 * 4 * 4, dtype=np.float32).reshape(8, 4, 4)
    rep = P.Report(None)
    vol = shard(x, make_mesh(4, devices=["cpu"] * 4), report=rep)
    assert rep.counts == {P.TO_DEVICE: x.nbytes}
    np.testing.assert_array_equal(
        to_host_np(torch.as_tensor(x[:2]), report=rep), x[:2])
    assert rep.counts == {P.TO_DEVICE: x.nbytes, P.TO_HOST: x[:2].nbytes}
    np.testing.assert_array_equal(to_host_np(vol), x)
