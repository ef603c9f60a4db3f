"""One run of one cell: set-up, the measured window, the metrics, the
check against the plain reference, and the result line.

The window drives one entry, ``visfd_tpu_torch.cli.filter_mrc.run(argv,
device, report=Report(stream))``, in this process, one tomogram a
request, back to back (one client, a closed loop).  A request starts
while the clock is under ``seconds``; the rate is all their work over
the time from the window's start to the end of the last one."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional, Tuple

from portbench.harness import clock, hostmem, mrcfile
from portbench.harness import trace as T
from portbench.harness.manifest import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "visfd_tpu")
SUFFIX = {"tomogram": ".mrc", "blob_list": ".txt"}


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    config: Dict
    traffic: Dict
    shape: Tuple[int, int, int]
    voxels: int
    requests: List[clock.RequestLog]
    window: Tuple[float, float]
    setup_s: float
    card_peak_bytes: int
    host_peak_bytes: int
    trace: Optional[T.DeviceTrace]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, whole)
    is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line(torch) -> Tuple[str, str]:
    """(card name, a line naming the card, the count and the power
    limit)."""
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        limit = "not read"
    return name, (f"portbench: {name} x{torch.cuda.device_count()}, power "
                  f"limit {limit}")


def _finite(v: float) -> float:
    return v if math.isfinite(v) else math.copysign(sys.float_info.max, v)


class Requests:
    """The argv of each request: the config's ``{name}`` placeholders
    filled with the inputs' paths and, for each output, a file under
    ``tmp`` (the window's first request, kept for the check) or what
    the config gives later requests (``devnull`` or ``tmpdir``)."""

    def __init__(self, config: Dict, inputs: Dict[str, str], tmp: str):
        self.config, self.inputs, self.tmp = config, inputs, tmp

    def outputs(self, first: bool) -> Dict[str, str]:
        out = {}
        for key, spec in self.config["outputs"].items():
            if not first and spec["later_requests"] == "devnull":
                out[key] = os.devnull
            else:
                out[key] = os.path.join(self.tmp, ("first_" if first else
                                                   "later_") + key
                                        + SUFFIX[spec["kind"]])
        return out

    def argv(self, outputs: Dict[str, str]) -> List[str]:
        paths = dict(self.inputs, **outputs)
        return [paths[a[1:-1]] if a.startswith("{") and a.endswith("}")
                else a for a in self.config["argv"]]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             shape: Optional[Tuple[int, int, int]] = None,
             out=None, err=None) -> int:
    """Run the cell once and print its result line; returns the exit
    code.  ``shape`` overrides the config's tomogram (the CPU tests)."""
    out = out or sys.stdout
    err = err or sys.stderr
    import torch
    marks = [("import torch", time.perf_counter())]
    on_card = torch.device(device).type == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell.chips):
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"visible: {torch.cuda.device_count()}", file=err)
        return 2
    kind = "cpu"
    if on_card:
        kind, line = card_line(torch)
        print(line, file=err, flush=True)

    from portbench.traffic import phantoms
    from visfd_tpu_torch.cli import filter_mrc
    from visfd_tpu_torch.utils.progress import Report

    config, traffic = cell.config, cell.traffic
    shape = tuple(shape or config["tomogram_zyx"])
    w = config["parameters"]["voxel_width_A"]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    marks.append(("the card and the program imported", time.perf_counter()))
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        vol, mask = phantoms.make(traffic, shape, w, seed, device)
        sync()
        marks.append(("phantom", time.perf_counter()))
        inputs = {"input": os.path.join(tmp, "input.mrc")}
        mrcfile.write(inputs["input"], vol.cpu().numpy(), w)
        if mask is not None:
            inputs["mask"] = os.path.join(tmp, "mask.mrc")
            mrcfile.write(inputs["mask"], mask.cpu().numpy(), w)
        del vol, mask
        marks.append(("input written", time.perf_counter()))
        reqs = Requests(config, inputs, tmp)

        def request(first: bool, label: Optional[str] = None):
            outputs = reqs.outputs(first)
            stream = clock.StageStream()
            rep = Report(stream)
            ctx = (torch.profiler.record_function(label) if label
                   else contextlib.nullcontext())
            t0 = time.perf_counter()
            ok = False
            with ctx:
                try:
                    ok = filter_mrc.run(reqs.argv(outputs), device=device,
                                        report=rep) == 0
                except Exception:   # counted as failed; the run goes on
                    traceback.print_exc(file=err)
                sync()
            return outputs, ok, clock.request_log(t0, time.perf_counter(),
                                                  stream, rep)

        request(False)                       # warm-up at the cell's shape
        marks.append(("warm-up request", time.perf_counter()))
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        prof = T.Profiler(tmp) if trace else None
        if prof:
            prof.start()
        logs: List[clock.RequestLog] = []
        failed = 0
        first_outputs: Dict[str, str] = {}
        with hostmem.HostPeak() as host:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                i = len(logs)
                outputs, ok, log = request(
                    i == 0, f"{T.REQUEST_PREFIX}{i}" if prof else None)
                failed += not ok
                logs.append(log)
                if i == 0:
                    first_outputs = outputs
        window = (t0, logs[-1].end)
        card_peak = torch.cuda.max_memory_allocated() if on_card else 0
        dtrace = None
        if prof:
            dtrace = prof.stop({i: r.start for i, r in enumerate(logs)},
                               window)
        ctx = Context(config, traffic, shape, math.prod(shape), logs, window,
                      t0 - t_start, card_peak, host.peak_bytes, dtrace)
        wanted = cell.per_layer if trace else cell.end_to_end
        metrics = {}
        for m in wanted:
            v = cell.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        steps, at = [], t_start
        for name, t in marks + [("window start", t0)]:
            steps.append(f"{name} {t - at:.3f}")
            at = t
        print(f"portbench: set-up seconds: {'; '.join(steps)}", file=err)
        print("portbench: request seconds: " + " ".join(
            f"{r.wall:.3f}" for r in logs), file=err)
        means: Dict[str, float] = {}
        for r in logs:
            for name, a, b in r.stages:
                means[name] = means.get(name, 0.0) + (b - a) / len(logs)
            means["unstaged"] = means.get("unstaged", 0.0) + (
                r.wall - r.staged_seconds()) / len(logs)
        print("portbench: stage seconds a request: " + "; ".join(
            f"{k} {v:.4f}" for k, v in means.items()), file=err)
        paths = " ".join(f"{k}={v}" for k, v in logs[0].paths.items())
        print(f"portbench: {len(logs)} requests, {failed} failed; host peak "
              f"by {host.method}; paths {paths}; counts {logs[0].counts}",
              file=err, flush=True)

        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        try:
            nums, info = cell.reference().check(first_outputs, inputs,
                                                config, device)
        except (OSError, ValueError):   # an output missing or unreadable
            traceback.print_exc(file=err)
            nums, info = {k: math.inf for k in config["limits"]}, {}
        info["seconds"] = time.perf_counter() - t_check
    limits = config["limits"]
    checks = {k: {"value": _finite(float(nums[k])), "limit": limits[k]}
              for k in limits}
    correct = (failed == 0 and len(logs) > 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    result = {"correct": correct, "attempted": len(logs), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": kind,
                         "count": cell.chips if on_card else 0,
                         "memory_peak_bytes": int(card_peak)}}
    if dtrace is not None:
        result["device"]["busy_s"] = dtrace.busy_s
        result["device"]["window_s"] = dtrace.window_s
        result["breakdown"] = T.breakdown(dtrace, logs)
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}: the run may load "
              f"neither JAX nor the JAX package; no result", file=err)
        return 3
    print(f"portbench: check details {info}", file=err)
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
