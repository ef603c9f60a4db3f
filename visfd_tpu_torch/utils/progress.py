"""Per-stage timing, execution-path telemetry and copy counters.

Port of ``visfd_tpu/utils/progress.py``.  A ``Report`` is the progress
sink of one run (the reference's ``ostream *pReportProgress``): it
keeps each stage's wall time, which implementation served each stage
and the run's counts (candidates, seeds, clusters of ``-connect``, the
bytes copied between host and device), and prints one grep-able summary
line of the paths.  A stage synchronises the card before it stops its
clock, so the time covers the kernels the stage queued.

While a ``torch.profiler`` records, every stage and span is also a
``record_function`` annotation of its name, so the trace shows each one
on the device trace's own clock, above the kernels and copies it queued
and inside the stage that encloses it.  Without a profiler no
annotation is opened (one flag read a stage or span).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, TextIO

import torch
import torch.autograd.profiler as _autograd_profiler

# the counters of host<->device copies (``utils/transfer``)
TO_DEVICE = "bytes to the device"
TO_HOST = "bytes to the host"


class Report:
    """A progress sink; ``write()`` mirrors the ostream protocol.
    ``Report(None)`` prints nothing but still records."""

    def __init__(self, stream: Optional[TextIO] = None):
        self.stream = stream
        self.timings = {}  # stage or span name -> seconds, summed
        self.paths = {}    # stage name -> implementation that served it
        self.counts = {}   # e.g. "connect candidates" -> voxels

    def write(self, msg: str) -> None:
        if self.stream is not None:
            self.stream.write(msg)
            self.stream.flush()

    def line(self, msg: str) -> None:
        self.write(msg + "\n")

    def record_path(self, stage_name: str, path: str) -> None:
        """Record which implementation served ``stage_name`` (e.g.
        ``"tv": "cuda-sparse"``)."""
        self.paths[stage_name] = path

    def record_count(self, name: str, n: int) -> None:
        """Record (and report) a count of the run, e.g. the candidate
        voxels of ``-connect``."""
        self.counts[name] = int(n)
        self.line(f"{name}: {int(n)}")

    def add_count(self, name: str, n: int) -> None:
        """Add ``n`` to the count ``name``, silently (a counter summed
        over the run, e.g. the bytes copied to the device)."""
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def format_paths(self) -> str:
        """e.g. ``stage paths: hessian_eigen=cuda tv=cuda-sparse``."""
        body = " ".join(f"{k}={v}" for k, v in self.paths.items())
        return f"stage paths: {body}" if body else "stage paths: (none)"

    def format_copies(self) -> str:
        """e.g. ``host<->device bytes: 1207959552 to the device,
        268435456 to the host``."""
        return (f"host<->device bytes: {self.counts.get(TO_DEVICE, 0)} to "
                f"the device, {self.counts.get(TO_HOST, 0)} to the host")


@contextlib.contextmanager
def _timed(name: str, report: Report):
    """The block inside ``record_function(name)`` while a profiler
    records, the card synchronised at its end, its wall seconds added
    to ``report.timings[name]``."""
    ann = (torch.profiler.record_function(name)
           if _autograd_profiler._is_profiler_enabled
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    try:
        with ann:
            try:
                yield
            finally:
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
    finally:
        report.timings[name] = (report.timings.get(name, 0.0)
                                + time.perf_counter() - t0)


@contextlib.contextmanager
def stage(name: str, report: Report):
    """Time a pipeline stage into ``report.timings`` (a stage that
    repeats adds up) and print its start and its seconds."""
    report.line(f"---- {name} ----")
    before = report.timings.get(name, 0.0)
    try:
        with _timed(name, report):
            yield report
    finally:
        dt = report.timings[name] - before
        report.line(f"---- {name}: {dt:.3f}s ----")


@contextlib.contextmanager
def span(name: str, report):
    """Add the block's wall time (the card synchronised at its end) to
    ``report.timings[name]``, silently, so a loop's parts add up; a
    ``report`` that is not a ``Report`` (None, a stream) times nothing."""
    if not isinstance(report, Report):
        yield
        return
    with _timed(name, report):
        yield
