"""print_mrc_stats: print MRC header stats (incl. recomputed max
brightness) like ``bin/print_mrc_stats/print_mrc_stats.cpp:1-34``.

A copy of ``visfd_tpu/cli/print_mrc_stats.py``.  No device is
involved: three reductions over the volume the host has just read.
"""

from __future__ import annotations

import sys

from visfd_tpu_torch.io import mrc


def run(argv) -> int:
    if len(argv) != 1:
        print("Error: expected one input file", file=sys.stderr)
        return 1
    img = mrc.read_mrc(argv[0])
    img.find_min_max_mean()
    img.header.print_stats(sys.stdout)
    return 0


def main():
    return run(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
