"""``csrc/eigen.cu``'s Hessian kernel on the binned grid: it reads the
blurred volume (4 B a voxel) and writes the planar score and the
principal eigenvector (16 B); 25 operations of finite differences, 90
of eigenvalues, 43 of the eigenvector and 4 of the planar score a voxel
(``chip_smoke.HESSIAN_OPS``, ``SCORE_OPS``)."""

BYTES_PER_VOXEL = 4 + 16
OPS_PER_VOXEL = 25 + 90 + 43 + 4
KERNEL = r"hessian_principal_kernel"


def LAUNCHES(ctx):
    return 1


def binned_voxels(ctx) -> int:
    b = int(ctx.config["parameters"]["bin"])
    nz, ny, nx = ctx.shape
    return (nz // b) * (ny // b) * (nx // b)


def work(ctx):
    n = binned_voxels(ctx)
    return BYTES_PER_VOXEL * n, OPS_PER_VOXEL * n
