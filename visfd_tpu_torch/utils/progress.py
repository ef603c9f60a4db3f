"""Per-stage timing and execution-path telemetry.

Port of ``visfd_tpu/utils/progress.py``.  A ``Report`` is the progress
sink of one run (the reference's ``ostream *pReportProgress``): it
keeps each stage's wall time, which implementation served each stage
and the run's counts (candidates, seeds, clusters of ``-connect``), and
prints one grep-able summary line of the paths.  A stage
synchronises the card before it stops its clock, so the time covers the
kernels the stage queued.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, TextIO

import torch


class Report:
    """A progress sink; ``write()`` mirrors the ostream protocol.
    ``Report(None)`` prints nothing but still records."""

    def __init__(self, stream: Optional[TextIO] = None):
        self.stream = stream
        self.timings = {}  # stage name -> seconds (last run)
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

    def format_paths(self) -> str:
        """e.g. ``stage paths: hessian_eigen=cuda tv=cuda-sparse``."""
        body = " ".join(f"{k}={v}" for k, v in self.paths.items())
        return f"stage paths: {body}" if body else "stage paths: (none)"


@contextlib.contextmanager
def stage(name: str, report: Report):
    """Time a pipeline stage into ``report.timings``."""
    report.line(f"---- {name} ----")
    t0 = time.perf_counter()
    try:
        yield report
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        report.timings[name] = dt
        report.line(f"---- {name}: {dt:.3f}s ----")


@contextlib.contextmanager
def span(name: str, report):
    """Add the block's wall time (the card synchronised at its end) to
    ``report.timings[name]``, silently, so a loop's parts add up; a
    ``report`` that is not a ``Report`` (None, a stream) times nothing."""
    if not isinstance(report, Report):
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        report.timings[name] = (report.timings.get(name, 0.0)
                                + time.perf_counter() - t0)
