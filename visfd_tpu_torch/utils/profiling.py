"""Profiling helpers.

Port of ``visfd_tpu/utils/profiling.py``: a device trace of a block of
work (``torch.profiler``, where the JAX package takes a
``jax.profiler`` trace).  Inside it every stage and span of a
``utils/progress.Report`` is an annotation above the kernels and copies
it queued.
"""

from __future__ import annotations

import contextlib
import os

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

