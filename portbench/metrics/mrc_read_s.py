"""Seconds a tomogram in ``io/mrc.read_mrc``: stage "read the tomogram"."""

from portbench.metrics import _stages as _S


def read(ctx):
    return _S.mean_stages(ctx, ["read the tomogram"])
