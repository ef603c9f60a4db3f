"""Profiling helpers.

Port of ``visfd_tpu/utils/profiling.py``: a device trace of a block of
work (``torch.profiler``, where the JAX package takes a
``jax.profiler`` trace) and best-of-N stage timings.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Sequence, Tuple

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU activities, and CUDA
    where a card is visible) and write it to ``log_dir`` as a Chrome
    trace, ``trace_<pid>.json`` (open it in Perfetto or
    chrome://tracing).  Yields the profiler; after the block its
    ``trace_path`` names the file.  Usage::

        with device_trace("chiprun_out/trace") as prof:
            out = step(x)
        print(prof.trace_path)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(prof.trace_path)


def stage_timings(
    stages: Sequence[Tuple[str, Callable[[], object]]],
    warmup: int = 1,
    iters: int = 3,
) -> Dict[str, float]:
    """Best-of-N wall seconds of each (name, thunk) stage, the card
    synchronised before each clock stops; the warm-up runs absorb the
    kernels' first-use builds."""
    def sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    out: Dict[str, float] = {}
    for name, thunk in stages:
        for _ in range(warmup):
            thunk()
        sync()
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            thunk()
            sync()
            best = min(best, time.perf_counter() - t0)
        out[name] = best
    return out
