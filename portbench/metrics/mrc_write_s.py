"""Seconds a tomogram in ``io/mrc.write_mrc``: stage "write the tomogram"."""

from portbench.metrics import _stages as _S


def read(ctx):
    return _S.mean_stages(ctx, ["write the tomogram"])
