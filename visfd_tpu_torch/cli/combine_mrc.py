"""combine_mrc: voxelwise + - * / of two MRC volumes with optional
per-input/output Threshold4, mask, and 0..1 rescaling.

Port of ``visfd_tpu/cli/combine_mrc.py`` (``bin/combine_mrc/
combine_mrc.cpp:16-200``): the thresholds (``ops/threshold``), the
operation and the mask run elementwise on ``device``; the read, the
rescale and the write on the host.  File arguments may carry
comma-suffixed thresholds: ``file.mrc,a[,b[,c[,d]]]`` (1 value = step
threshold, 2 = ramp, 4 = trapezoid).  Usage:
``python -m visfd_tpu_torch.cli.combine_mrc [opts] in1[,t...] OP
in2[,t...] out[,t...]``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.ops import threshold as T
from visfd_tpu_torch.parallel.gather import to_host_np
from visfd_tpu_torch.utils.transfer import to_device


def _parse_file_arg(arg):
    parts = arg.split(",")
    name = parts[0]
    th = None
    if len(parts) > 1:
        vals = [float(v) for v in parts[1:]]
        a = vals[0]
        b = vals[1] if len(vals) > 1 else a
        c = vals[2] if len(vals) > 2 else b
        d = vals[3] if len(vals) > 3 else c
        th = (a, b, c, d)
    return name, th


def _apply_th4(x: torch.Tensor, th) -> torch.Tensor:
    a, b, c, d = th
    if (b == c) and (b == d):
        # Threshold4 degenerates to Threshold2 (threshold.hpp:127-130)
        if a == b:
            return torch.where(x > a, 1.0, 0.0)
        return T.threshold2(x, a, b)
    return T.threshold4(x, a, b, c, d)


_OPS = {"+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div}


def run(argv, device="cuda") -> int:
    """combine_mrc on ``argv`` with the voxel work on ``device`` (a
    library argument: the command line always uses CUDA)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("visfd_tpu_torch: no CUDA device is visible; "
                           "combine_mrc runs on an NVIDIA GPU")
    args = list(argv)
    mask_name = ""
    use_mask_select = False
    mask_select = 1
    use_mask_out = False
    mask_out = 0.0
    rescale = False
    pos = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-mask":
            mask_name = args[i + 1]; i += 1
        elif a == "-mask-select":
            use_mask_select = True; mask_select = int(args[i + 1]); i += 1
        elif a == "-mask-out":
            use_mask_out = True; mask_out = float(args[i + 1]); i += 1
        elif a == "-rescale":
            rescale = True
        elif a == "-norescale":
            rescale = False
        else:
            pos.append(a)
        i += 1
    if len(pos) != 4:
        print("Usage: combine_mrc in1[,thresh...] OP in2[,thresh...] "
              "out[,thresh...]", file=sys.stderr)
        return 1
    in1, th1 = _parse_file_arg(pos[0])
    op = _OPS.get(pos[1][0])
    in2, th2 = _parse_file_arg(pos[2])
    out_name, th_out = _parse_file_arg(pos[3])

    img1 = mrc.read_mrc(in1, rescale=rescale and th1 is None)
    img1.header.print_stats(sys.stderr)
    img2 = mrc.read_mrc(in2, rescale=rescale and th2 is None)
    img2.header.print_stats(sys.stderr)
    if img1.data.shape != img2.data.shape:
        print("Error: The size of the two input tomograms does not match.",
              file=sys.stderr)
        return 1
    if op is None:
        print(f'Error: Unrecognized binary operation: "{pos[1][0]}"',
              file=sys.stderr)
        return 1
    x1 = to_device(img1.data, device)
    x2 = to_device(img2.data, device)
    if th1 is not None:
        x1 = _apply_th4(x1, th1)
    if th2 is not None:
        x2 = _apply_th4(x2, th2)

    mask = mask_np = None
    if mask_name:
        mask_np = mrc.read_mrc(mask_name).data
        if use_mask_select:
            mask_np = np.where(mask_np == mask_select, 1.0, 0.0)
        mask = to_device(mask_np, device) == 0  # outside

    out = op(x1, x2)
    del x2
    if mask is not None:
        out = torch.where(mask, x1, out)
    del x1
    if th_out is not None:
        th_applied = _apply_th4(out, th_out)
        out = (torch.where(mask, out, th_applied) if mask is not None
               else th_applied)
    if mask is not None and use_mask_out:
        out = torch.where(mask, mask_out, out)
    oimg = mrc.MrcImage(header=img1.header, data=to_host_np(out, np.float32))
    if rescale:
        oimg.rescale01(mask_np)
    oimg.write(out_name)
    return 0


def main():
    """Command-line entry: the voxel work runs on the CUDA card."""
    return run(sys.argv[1:], device="cuda")


if __name__ == "__main__":
    sys.exit(main())
