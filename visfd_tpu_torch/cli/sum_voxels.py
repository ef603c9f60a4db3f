"""sum_voxels: (mask-weighted) sum / -ave / -stddev of an MRC volume
with optional thresholds; prints one number.

Port of ``visfd_tpu/cli/sum_voxels.py`` (``bin/sum_voxels/
sum_voxels.cpp:100-200``).  The ramps of ``-thresh2``, ``-clip`` and
``-thresh4`` run on ``device`` in float32, as the JAX tool's do (its
float64 input becomes float32 on the way into ``jnp``); the sums are
numpy's on the host, over the same arrays as the JAX tool's, so the
printed line is the same byte for byte.  Usage:
``python -m visfd_tpu_torch.cli.sum_voxels [options] file.rec``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.io.coords import fmt_g
from visfd_tpu_torch.ops import threshold as T
from visfd_tpu_torch.utils.transfer import to_device, to_host


def run(argv, device="cuda") -> int:
    """sum_voxels on ``argv`` with the thresholds on ``device`` (a
    library argument: the command line always uses CUDA)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("visfd_tpu_torch: no CUDA device is visible; "
                           "sum_voxels runs on an NVIDIA GPU")
    args = list(argv)
    mask_name = ""
    use_mask_select = False
    mask_select = 1
    calc_ave = calc_stddev = False
    mult_voxel_volume = False
    voxel_width = -1.0
    use_thresholds = use_dual = False
    clip = False
    t01a = t01b = t10a = t10b = 1.0
    ta, tb = 0.0, 1.0
    pos = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-mask":
            mask_name = args[i + 1]; i += 1
        elif a == "-mask-select":
            use_mask_select = True; mask_select = int(args[i + 1]); i += 1
        elif a in ("-ave", "-average"):
            calc_ave = True
        elif a == "-stddev":
            calc_stddev = True
        elif a in ("-volume", "-vol"):
            mult_voxel_volume = True
        elif a == "-w":
            voxel_width = float(args[i + 1]); i += 1
        elif a == "-thresh":
            use_thresholds = True; use_dual = False
            t01a = t01b = float(args[i + 1]); i += 1
        elif a == "-thresh2":
            use_thresholds = True; use_dual = False
            t01a = float(args[i + 1]); t01b = float(args[i + 2]); i += 2
        elif a == "-clip":
            use_thresholds = True; use_dual = False; clip = True
            t01a = float(args[i + 1]); t01b = float(args[i + 2]); i += 2
        elif a == "-thresh4":
            use_thresholds = True; use_dual = True
            t01a = float(args[i + 1]); t01b = float(args[i + 2])
            t10a = float(args[i + 3]); t10b = float(args[i + 4]); i += 4
        elif a.startswith("-"):
            print(f"Error: unrecognized argument {a}", file=sys.stderr)
            return 1
        else:
            pos.append(a)
        i += 1
    if len(pos) != 1:
        print("Error: expected one input file", file=sys.stderr)
        return 1

    img = mrc.read_mrc(pos[0])
    mask = None
    if mask_name:
        mask = mrc.read_mrc(mask_name).data
        if use_mask_select:
            mask = np.where(mask == mask_select, 1.0, 0.0)

    def ramp(fn, *targs):
        return to_host(fn(to_device(img.data, device), *targs))

    if not use_thresholds:
        x = img.data.astype(np.float64)
    elif use_dual:
        x = ramp(T.threshold4, t01a, t01b, t10a, t10b, ta, tb)
    else:
        oa = t01a if clip else ta
        ob = t01b if clip else tb
        if t01a == t01b:
            x = np.where(img.data.astype(np.float64) > t01a, ob, oa)
        else:
            x = ramp(T.threshold2, t01a, t01b, oa, ob)

    if mask is not None:
        sum_ = float((x * mask).sum())
        denom = float(mask.sum())
    else:
        sum_ = float(x.sum())
        denom = float(x.size)
    ave = sum_ / denom if denom > 0 else -1.0

    if calc_ave:
        print(fmt_g(ave))
    elif calc_stddev:
        sq = (x - ave) ** 2
        if mask is not None:
            std = np.sqrt(float((sq * mask).sum()) / denom)
        else:
            std = np.sqrt(float(sq.sum()) / denom)
        print(fmt_g(std))
    else:
        mult = 1.0
        if mult_voxel_volume:
            w = voxel_width if voxel_width > 0 else img.voxel_width_xyz[0]
            mult = w ** 3
        print(fmt_g(sum_ * mult))
    return 0


def main():
    """Command-line entry: the thresholds run on the CUDA card."""
    return run(sys.argv[1:], device="cuda")


if __name__ == "__main__":
    sys.exit(main())
