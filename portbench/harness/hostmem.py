"""The host's resident memory over a window.

Where the kernel lets the process reset its high-water mark (``5`` into
``/proc/self/clear_refs``) and reports it (``VmHWM`` in
``/proc/self/status``), that is read.  Otherwise a child process (so
that sampling takes no turn of this interpreter's lock) reads this
process's ``/proc/<pid>/statm`` every ``PERIOD_S`` and keeps the
largest; a peak shorter than the period can be missed.  ``method``
says which ran."""

from __future__ import annotations

import os
import subprocess
import sys

PERIOD_S = 0.002
_PAGE = os.sysconf("SC_PAGE_SIZE")

# the sampler: reads the parent's resident pages until its stdin closes,
# then prints the largest count
_SAMPLER = r"""
import select, sys
path, period, most = sys.argv[1], float(sys.argv[2]), 0
while True:
    with open(path) as fh:
        most = max(most, int(fh.read().split()[1]))
    if select.select([sys.stdin], [], [], period)[0]:
        break
print(most, flush=True)
"""


def _vm_hwm_bytes():
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def _rss_bytes() -> int:
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * _PAGE


class HostPeak:
    """``with HostPeak() as hp: ...``; then ``hp.peak_bytes`` and
    ``hp.method`` ("VmHWM" or "statm sampler")."""

    def __init__(self):
        self.peak_bytes = 0
        self.method = None
        self._child = None

    def __enter__(self):
        try:
            with open("/proc/self/clear_refs", "w") as fh:
                fh.write("5")
            hwm = _vm_hwm_bytes()
        except OSError:
            hwm = None
        if hwm is not None:
            self.method = "VmHWM"
            return self
        self.method = "statm sampler"
        self.peak_bytes = _rss_bytes()
        self._child = subprocess.Popen(
            [sys.executable, "-c", _SAMPLER, f"/proc/{os.getpid()}/statm",
             str(PERIOD_S)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)
        return self

    def __exit__(self, *exc):
        if self._child is not None:
            out, _ = self._child.communicate("", timeout=60)
            pages = int(out.strip() or 0)
            self.peak_bytes = max(self.peak_bytes, pages * _PAGE,
                                  _rss_bytes())
        else:
            self.peak_bytes = _vm_hwm_bytes() or _rss_bytes()
        return False
