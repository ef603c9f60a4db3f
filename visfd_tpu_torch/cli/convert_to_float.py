"""convert_to_float: rewrite any supported MRC mode as float32
(``bin/convert_to_float/convert_to_float.cpp:1-52``).

A copy of ``visfd_tpu/cli/convert_to_float.py``.  No device is
involved: the file is read, converted and written on the host.
"""

from __future__ import annotations

import sys

from visfd_tpu_torch.io import mrc


def run(argv) -> int:
    if len(argv) != 2:
        print("Usage: convert_to_float IN OUT", file=sys.stderr)
        return 1
    img = mrc.read_mrc(argv[0])
    img.header.print_stats(sys.stderr)
    mrc.write_mrc(argv[1], img.data, header=img.header)
    return 0


def main():
    return run(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
