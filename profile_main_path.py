#!/usr/bin/env python3
"""Where the time of one ``filter_mrc -membrane … -tv …`` run goes, on
one NVIDIA GPU, for the PyTorch port (visfd_tpu_torch).

    python3 profile_main_path.py

Writes a seeded phantom tomogram (``utils/phantom.py``, 512 x 512 x 256
voxels, X x Y x Z, as in ``chip_smoke.py``) to an MRC file, runs the
port's CLI on it once to warm up (kernel build, CUDA context), then
three times, timing each run's wall on the host clock and its MRC read
and write.  The last run is traced with ``torch.profiler``; the device
time is summed per kernel and per copy direction, and set against the
wall.  Last, the ``-tv-best`` threshold over the score the run
thresholded: ``torch.sort`` (what ``parallel/reduce.py`` uses) against
``torch.kthvalue``, CUDA events.  Prints the card's name and power
limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ARGS = "-w 1 -membrane minima 3 -tv 1.5 -tv-angle-exponent 4"
SHAPE = (256, 512, 512)  # (Z, Y, X)
REPEATS = 3
SEED = 1234

# device-time groups: (label, predicate on the profiler's event name)
GROUPS = [
    ("blur (conv1d_axis_kernel)", lambda n: "conv1d_axis_kernel" in n),
    ("Hessian + eigen (hessian_principal_kernel)",
     lambda n: "hessian_principal_kernel" in n),
    ("voting (tv_votes_kernel)", lambda n: "tv_votes_kernel" in n),
    ("vote eigen (sym3_score_kernel)", lambda n: "sym3_score_kernel" in n),
    ("copy host -> device", lambda n: "HtoD" in n),
    ("copy device -> host", lambda n: "DtoH" in n),
    ("sort (threshold)", lambda n: "sort" in n.lower() or "radix" in n.lower()),
]


def _device_us(evt) -> float:
    """Device microseconds of a profiler row that is itself a device
    event (a kernel or a copy); 0 for host rows, whose device columns
    repeat the time of the kernels they launched."""
    from torch.autograd import DeviceType
    if getattr(evt, "device_type", None) != DeviceType.CUDA:
        return 0.0
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _timed(fn, store, key):
    def wrapped(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            store[key] = store.get(key, 0.0) + time.perf_counter() - t0
    return wrapped


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_main_path: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from visfd_tpu_torch.cli import filter_mrc as TFM
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.parallel.reduce import fraction_threshold
    from visfd_tpu_torch.utils.phantom import membrane_phantom
    from visfd_tpu_torch.utils.progress import Report

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    shape = SHAPE
    print(f"filter_mrc {ARGS} on {shape[2]}x{shape[1]}x{shape[0]} "
          f"(X x Y x Z) voxels")

    host, seen = {}, {}
    TFM.mrc.read_mrc = _timed(mrc.read_mrc, host, "read_mrc")
    TFM.mrc.write_mrc = _timed(mrc.write_mrc, host, "write_mrc")

    def spy_threshold(score, fraction, mask=None):
        seen["score"], seen["fraction"] = score, fraction
        return fraction_threshold(score, fraction, mask=mask)
    TFM.fraction_threshold = spy_threshold
    with tempfile.TemporaryDirectory(prefix=".tmp_profile_", dir=ROOT) as tmp:
        vol, _ = membrane_phantom(shape, seed=SEED, thickness=3.0,
                                  device="cuda")
        fin, fout = os.path.join(tmp, "in.mrc"), os.path.join(tmp, "out.mrc")
        mrc.write_mrc(fin, vol.cpu().numpy())
        argv = ["-in", fin, "-out", fout] + ARGS.split()

        def one_run(rep):
            host.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = TFM.run(argv, device="cuda", report=rep)
            wall = time.perf_counter() - t0
            if rc != 0:
                raise SystemExit(f"filter_mrc exited {rc}")
            return wall

        one_run(Report(None))  # warm-up: build, context, allocator
        for i in range(REPEATS):
            rep = Report(None)
            if i == REPEATS - 1:
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    wall = one_run(rep)
            else:
                wall = one_run(rep)
            stages = ", ".join(f"{k} {v:.4f} s"
                               for k, v in rep.timings.items())
            print(f"run {i + 1}{' (traced)' if i == REPEATS - 1 else ''}"
                  f": wall {wall:.4f} s; read_mrc {host['read_mrc']:.4f} s, "
                  f"write_mrc {host['write_mrc']:.4f} s; {stages} [{card}]")

        rows = {label: 0.0 for label, _ in GROUPS}
        total = 0.0
        for evt in prof.key_averages():
            us = _device_us(evt)
            if us <= 0:
                continue
            total += us
            for label, match in GROUPS:
                if match(evt.key):
                    rows[label] += us
                    break
        print(f"device time of the traced run [{card}]:")
        for label, us in rows.items():
            print(f"  {label:45s} {us / 1e3:10.3f} ms")
        print(f"  {'other':45s} {(total - sum(rows.values())) / 1e3:10.3f} ms")
        print(f"  {'all':45s} {total / 1e3:10.3f} ms = "
              f"{total / 1e6 / wall:.3f} of the wall ({wall:.4f} s)")
        if total == 0:
            print("  (the profiler saw no device time)")

        # the -tv-best threshold: sort against kthvalue on the score the
        # CLI thresholded (no mask)
        score, frac = seen["score"], seen["fraction"]
        vals = score.reshape(-1)
        kk = vals.numel() - int(np.floor(vals.numel() * frac))
        times = {}
        for name, fn in (
                ("torch.sort", lambda: fraction_threshold(score, frac)),
                ("torch.kthvalue",
                 lambda: float(torch.kthvalue(vals, kk).values))):
            fn()
            ms = []
            for _ in range(3):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            times[name] = float(np.median(ms))
        same = fraction_threshold(score, frac) == float(
            torch.kthvalue(vals, kk).values)
        print(f"-tv-best {frac} threshold over {vals.numel()} voxels: "
              + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items())
              + f" (same value: {same}) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
