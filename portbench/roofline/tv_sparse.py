"""``csrc/tv.cu`` in its sparse mode (``-tv-best``): it reads the
saliency and the direction (16 B a voxel) and writes the 6 vote
channels (24 B); 33 operations for every kept source and tap of
non-zero weight at angle exponent 4 (``chip_smoke.tv_work``).  The kept
sources are the -tv-best fraction of the binned voxels: floor(n f) + 1,
the voxels at or above the threshold where no two scores tie."""

import math

from portbench.references import membrane_tv as R
from portbench.roofline.hessian_eigen import binned_voxels

KERNEL = r"tv_votes_kernel"
OPS_PER_TAP = 33
BYTES_PER_VOXEL = 16 + 24


def LAUNCHES(ctx):
    return 1


def taps(p) -> int:
    sigma = (p["tv_sigma_per_blur_sigma"] * p["thickness_A"]
             / math.sqrt(3.0) / (p["voxel_width_A"] * p["bin"]))
    hw = int(math.floor(sigma * p["tv_truncate_ratio"]))
    return int((R.gen_gauss_table(sigma, hw) != 0).sum())


def work(ctx):
    p = ctx.config["parameters"]
    n = binned_voxels(ctx)
    kept = min(int(math.floor(n * p["tv_best"])), n - 1) + 1
    return BYTES_PER_VOXEL * n, OPS_PER_TAP * kept * taps(p)
