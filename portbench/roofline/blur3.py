"""``csrc/blur.cu``'s fused kernel over the blob ladder: 4 launches a
scale (the masked numerator and the mask, at the two sigmas of the
scale's LoG), each reading and writing the volume once (8 B a voxel)
and doing one FMA per tap and axis (2 operations) at the scale's
halfwidth on every axis (``chip_smoke.BLUR_OPS_PER_TAP``)."""

from portbench.references import blob_ribosome as R

KERNEL = r"blur3_kernel"
OPS_PER_TAP = 2
BYTES_PER_VOXEL = 8
LAUNCHES_PER_SCALE = 4


def LAUNCHES(ctx):
    return LAUNCHES_PER_SCALE * len(R.sigmas(ctx.config["parameters"]))


def work(ctx):
    p = ctx.config["parameters"]
    nvox = ctx.voxels
    nbytes = nops = 0
    for s in R.sigmas(p):
        hw = R.log_halfwidth(s, p)
        nbytes += LAUNCHES_PER_SCALE * BYTES_PER_VOXEL * nvox
        nops += LAUNCHES_PER_SCALE * OPS_PER_TAP * 3 * (2 * hw + 1) * nvox
    return nbytes, nops
