"""Kernels' roofline shares: the least time the card could take for a
kernel's work over the time the trace gives it.

The least time is the larger of its bytes (each input read once, each
output written once) over the memory rate and its float32 operations
over the peak rate (``peaks.json``: the H100 SXM's published 3.35 TB/s
and 67 TFLOP/s outside the tensor cores, at 700 W).  Each kernel is a
file ``<kernel>.py`` here with ``KERNEL`` (a regular expression on the
profiler's kernel names), ``LAUNCHES(ctx)`` (launches a request) and
``work(ctx)`` ((bytes, operations) a request).  Operations are counted
from ``visfd_tpu_torch/csrc/``: a product, a sum, a division, a square
root, a comparison or a transcendental each count one, an FMA two."""

from __future__ import annotations

import json
import os
from typing import Optional

from portbench.harness.manifest import load_module

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks():
    with open(os.path.join(HERE, "peaks.json")) as fh:
        return json.load(fh)


def bound_s(nbytes: float, nops: float) -> float:
    p = peaks()
    return max(nbytes / p["hbm_bytes_per_s"], nops / p["fp32_ops_per_s"])


def kernel(name: str):
    return load_module(os.path.join(HERE, f"{name}.py"),
                       f"portbench_roofline_{name}")


def share(ctx, name: str) -> Optional[float]:
    """The window's share, in %, of kernel ``name``'s roofline; None
    without a trace, without its launches, or where the trace's launches
    are not the requests' (the work would be another's)."""
    if ctx.trace is None:
        return None
    k = kernel(name)
    seconds, launches = ctx.trace.kernel_seconds(k.KERNEL)
    n = len(ctx.requests)
    if launches == 0 or seconds <= 0 or launches != k.LAUNCHES(ctx) * n:
        return None
    nbytes, nops = k.work(ctx)
    return 100.0 * n * bound_s(nbytes, nops) / seconds
