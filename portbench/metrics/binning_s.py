"""Seconds a tomogram in ``cli/filter_mrc.handle_binning``: stage "bin
the tomogram" (the whole tomogram's upload, ``bin_array3d`` and the
binned download, and the mask's)."""

from portbench.metrics import _stages as _S


def read(ctx):
    return _S.mean_stages(ctx, ["bin the tomogram"])
