"""crop_mrc: crop (inclusive bounds) + optional padding with a fill
brightness. Parity with ``bin/crop_mrc/crop_mrc.cpp:11-155``.

Usage: crop_mrc IN OUT xmin xmax ymin ymax zmin zmax
       [xpad Xpad ypad Ypad zpad Zpad [brightness]]

A copy of ``visfd_tpu/cli/crop_mrc.py``.  No device is involved: a
crop is one slice copy on the host between the read and the write.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from visfd_tpu_torch.io import mrc


def run(argv) -> int:
    if len(argv) not in (8, 14, 15):
        print("Usage: crop_mrc IN OUT xmin xmax ymin ymax zmin zmax "
              "[xpad Xpad ypad Ypad zpad Zpad [B]]", file=sys.stderr)
        return 1
    in_name, out_name = argv[0], argv[1]
    xmin, xmax, ymin, ymax, zmin, zmax = (int(v) for v in argv[2:8])
    pads = [0] * 6
    fill = 0.0
    if len(argv) > 8:
        pads = [int(v) for v in argv[8:14]]
        if len(argv) == 15:
            fill = float(argv[14])
    xpad, Xpad, ypad, Ypad, zpad, Zpad = pads

    img = mrc.read_mrc(in_name)
    img.header.print_stats(sys.stderr)
    nz, ny, nx = img.data.shape
    xmin = max(xmin, 0); ymin = max(ymin, 0); zmin = max(zmin, 0)
    xmax = min(xmax, nx - 1); ymax = min(ymax, ny - 1)
    zmax = min(zmax, nz - 1)

    vox = img.header.voxel_width_xyz
    new_shape = (1 + zmax - zmin + zpad + Zpad,
                 1 + ymax - ymin + ypad + Ypad,
                 1 + xmax - xmin + xpad + Xpad)
    out = np.full(new_shape, fill, np.float32)
    out[zpad:zpad + 1 + zmax - zmin,
        ypad:ypad + 1 + ymax - ymin,
        xpad:xpad + 1 + xmax - xmin] = \
        img.data[zmin:zmax + 1, ymin:ymax + 1, xmin:xmax + 1]

    h = dataclasses.replace(img.header)
    h.cellA = (img.header.cellA[0] * (1.0 + xmax - xmin) / nx,
               img.header.cellA[1] * (1.0 + ymax - ymin) / ny,
               img.header.cellA[2] * (1.0 + zmax - zmin) / nz)
    h.origin = (img.header.origin[0] + (xpad - xmin) * vox[0],
                img.header.origin[1] + (ypad - ymin) * vox[1],
                img.header.origin[2] + (zpad - zmin) * vox[2])
    mrc.write_mrc(out_name, out, header=h)
    return 0


def main():
    return run(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
