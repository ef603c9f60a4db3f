"""The stage clock: a stream for ``Report`` that timestamps each stage
line, and the log of one request.

``utils/progress.stage`` writes ``---- name ----`` when a stage starts
and ``---- name: 1.234s ----`` when it ends (after synchronising the
card), so the time of each write gives the stage's interval on the host
clock.  A name that repeats in one request adds up; ``Report.timings``
keeps only its last interval.  The silent spans (``utils/progress.
span``) are read from ``Report.timings`` after the request."""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Tuple

_END = re.compile(r"^---- (.+): [0-9.]+s ----$")
_START = re.compile(r"^---- (.+) ----$")


class StageStream:
    """A text stream that records (name, start, end) of every stage on
    ``time.perf_counter``; it drops every other line."""

    def __init__(self):
        self.stages: List[Tuple[str, float, float]] = []
        self._open: List[Tuple[str, float]] = []
        self._buf = ""

    def write(self, msg: str) -> int:
        now = time.perf_counter()
        self._buf += msg
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self._line(line, now)
        return len(msg)

    def flush(self) -> None:
        pass

    def _line(self, line: str, now: float) -> None:
        m = _END.match(line)
        if m and self._open and self._open[-1][0] == m.group(1):
            name, t0 = self._open.pop()
            self.stages.append((name, t0, now))
            return
        m = _START.match(line)
        if m:
            self._open.append((m.group(1), now))


@dataclasses.dataclass
class RequestLog:
    """One request: its host interval, its stages' intervals, its
    spans' seconds (``Report.timings`` of the names no stage took) and
    its paths and counts."""
    start: float
    end: float
    stages: List[Tuple[str, float, float]]
    spans: Dict[str, float]
    paths: Dict[str, str]
    counts: Dict[str, int]

    @property
    def wall(self) -> float:
        return self.end - self.start

    def stage_seconds(self, name: str) -> float:
        """The seconds of every interval of stage ``name``."""
        return sum(t1 - t0 for n, t0, t1 in self.stages if n == name)

    def staged_seconds(self) -> float:
        """The seconds the union of the stages covers."""
        total, reach = 0.0, float("-inf")
        for _, t0, t1 in sorted((s for s in self.stages),
                                key=lambda s: s[1]):
            lo = max(t0, reach)
            if t1 > lo:
                total += t1 - lo
            reach = max(reach, t1)
        return total


def request_log(start: float, end: float, stream: StageStream,
                report) -> RequestLog:
    staged = {n for n, _, _ in stream.stages}
    spans = {k: float(v) for k, v in report.timings.items()
             if k not in staged}
    return RequestLog(start, end, list(stream.stages), spans,
                      dict(report.paths), dict(report.counts))
