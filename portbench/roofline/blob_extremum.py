"""``csrc/blob_extremum.cu``, the blob ladder's 4-D extremum test: one
launch a mid scale (all but the ladder's first and last), each reading
the three float32 scales once and, with ``-mask``, the mask's validity
byte (13 B a voxel; 12 without a mask).  The code byte a voxel that the
kernel also writes for the compaction is not the test's work and is
left out.  Operations a voxel, counted from the source (a minimum, a
maximum or a comparison each one): the 3-wide minima and maxima along x
of a thread's 6 rows for its 4 voxels (6 a scale), the 3x3 boxes (4 a
scale), the mid scale's ring (4), the boxes below and above folded (2),
A and B (4), the 80-neighbour minimum and maximum (4) and the four
comparisons of the two tests (4): 48."""

from portbench.references import blob_ribosome as R

KERNEL = r"blob_extremum_kernel"
OPS_PER_VOXEL = 3 * (6 + 4) + 4 + 2 + 4 + 4 + 4


def LAUNCHES(ctx):
    return len(R.sigmas(ctx.config["parameters"])) - 2


def work(ctx):
    per_voxel = 12 + ("-mask" in ctx.config["argv"])
    n = LAUNCHES(ctx) * ctx.voxels
    return per_voxel * n, OPS_PER_VOXEL * n
