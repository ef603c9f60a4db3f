"""histogram_mrc: voxel-intensity histogram of an MRC file with
optional mask and -mask-select. Parity with
``bin/histogram_mrc/histogram_mrc.py:1-131`` -- prints bin centers and
counts; plotting (matplotlib) is optional via -plot.

A copy of ``visfd_tpu/cli/histogram_mrc.py``.  No device is
involved: one ``np.histogram`` over the volume the host has just read,
whose bin edges (numpy's 'auto' rule) the output must keep.
"""

from __future__ import annotations

import sys

import numpy as np

from visfd_tpu_torch.io import mrc


def run(argv) -> int:
    args = list(argv)
    nbins = -1
    rescale01 = False
    mask_name = ""
    mask_select = None
    plot = False
    pos = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-n":
            nbins = int(args[i + 1]); i += 1
        elif a == "-rescale":
            rescale01 = True
        elif a in ("-mask", "-m"):
            mask_name = args[i + 1]; i += 1
        elif a == "-mask-select":
            mask_select = int(args[i + 1]); i += 1
        elif a == "-plot":
            plot = True
        elif a.startswith("-"):
            print(f"Error: unrecognized argument {a}", file=sys.stderr)
            return 1
        else:
            pos.append(a)
        i += 1
    if len(pos) != 1:
        print("Error: You must supply the name of a file in .MRC (.REC) "
              "format.", file=sys.stderr)
        return 1

    img = mrc.read_mrc(pos[0])
    mask = None
    if mask_name:
        mask = mrc.read_mrc(mask_name).data
        if mask_select is not None:
            mask = np.where(mask == mask_select, 1.0, 0.0)
    if rescale01:
        img.rescale01(mask)
    vals = img.data[mask != 0] if mask is not None else img.data.ravel()
    if nbins <= 0:
        # Freedman-Diaconis fallback like numpy 'auto'
        nbins = "auto"
    counts, edges = np.histogram(vals, bins=nbins)
    centers = 0.5 * (edges[:-1] + edges[1:])
    for c, n in zip(centers, counts):
        print(f"{c:.6g} {n}")
    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.bar(centers, counts, width=(edges[1] - edges[0]))
        plt.xlabel("intensity")
        plt.ylabel("number of voxels")
        plt.savefig(pos[0] + "_histogram.png")
    return 0


def main():
    return run(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
