"""The device trace of a window (``torch.profiler``, CPU and CUDA
activities) reduced to what the per-layer metrics read: the device
operations' intervals, the busy time (their union), the window's
length, and the host stages mapped onto the trace's clock.

Each request runs inside ``record_function("portbench.request.<i>")``;
the host clock at its entry against the annotation's start in the
trace gives the offset between the two clocks (the median over the
requests)."""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
REQUEST_PREFIX = "portbench.request."


@dataclasses.dataclass
class DeviceTrace:
    """Times in seconds on the host's ``perf_counter`` clock."""
    window: Tuple[float, float]
    ops: List[Tuple[str, float, float]]     # (name, start, end), clipped
    busy_s: float

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [(t0, t1) for n, t0, t1 in self.ops if rx.search(n)]
        return sum(t1 - t0 for t0, t1 in hits), len(hits)


def union_seconds(intervals) -> float:
    total, reach = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        lo = max(t0, reach)
        if t1 > lo:
            total += t1 - lo
        reach = max(reach, t1)
    return total


def busy_intervals(intervals) -> List[Tuple[float, float]]:
    """The union as disjoint sorted intervals."""
    out: List[List[float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return name[:cut] if cut > 0 else name


def reduce_chrome_trace(path: str, request_starts: Dict[int, float],
                        window: Tuple[float, float]) -> DeviceTrace:
    """Read the trace ``path`` and keep the device operations inside the
    host ``window``; ``request_starts`` maps a request's index to the
    host time at which its annotation opened."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    offsets = []
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith(
                REQUEST_PREFIX):
            i = int(name[len(REQUEST_PREFIX):])
            if i in request_starts:
                offsets.append(e["ts"] * 1e-6 - request_starts[i])
    if not offsets:
        raise RuntimeError("the trace holds no request annotation")
    off = statistics.median(offsets)
    lo, hi = window
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        t0 = e["ts"] * 1e-6 - off
        t1 = t0 + e["dur"] * 1e-6
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 > t0:
            ops.append((e.get("name", "?"), t0, t1))
    return DeviceTrace(window, ops, union_seconds((a, b) for _, a, b in ops))


def breakdown(trace: DeviceTrace, requests, top: int = 10) -> Dict:
    """The device operations that took most time (summed by name), and
    the idle time of the device summed by the host stage it fell in
    ("unstaged" outside every stage, "between requests" outside every
    request)."""
    by_op: Dict[str, float] = {}
    for n, t0, t1 in trace.ops:
        k = short_name(n)
        by_op[k] = by_op.get(k, 0.0) + (t1 - t0)
    busy = busy_intervals((a, b) for _, a, b in trace.ops)
    gaps, at = [], trace.window[0]
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if trace.window[1] > at:
        gaps.append((at, trace.window[1]))
    labelled = []          # (name, start, end), innermost stage first
    for r in requests:
        for n, t0, t1 in sorted(r.stages, key=lambda s: s[2] - s[1]):
            labelled.append((n, t0, t1))
        labelled.append(("unstaged", r.start, r.end))
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        left = [(g0, g1)]
        for n, t0, t1 in labelled:
            rest = []
            for a, b in left:
                lo, hi = max(a, t0), min(b, t1)
                if hi > lo:
                    idle[n] = idle.get(n, 0.0) + (hi - lo)
                    if lo > a:
                        rest.append((a, lo))
                    if b > hi:
                        rest.append((hi, b))
                else:
                    rest.append((a, b))
            left = rest
        for a, b in left:
            idle["between requests"] = idle.get("between requests",
                                                0.0) + (b - a)

    def first(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": first(by_op), "idle_gaps": first(idle)}


class Profiler:
    """``torch.profiler`` over the window, exported as a Chrome trace
    into ``directory`` and reduced there; the file is removed after."""

    def __init__(self, directory: str):
        import torch
        self.torch = torch
        self.path = os.path.join(directory, "window_trace.json")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def start(self):
        self.prof.start()

    def stop(self, request_starts, window) -> DeviceTrace:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        try:
            return reduce_chrome_trace(self.path, request_starts, window)
        finally:
            os.remove(self.path)
