"""Seconds a tomogram in ``io/mrc.read_mrc`` of the ``-mask`` file:
stage "read the mask"."""

from portbench.metrics import _stages as _S


def read(ctx):
    return _S.mean_stages(ctx, ["read the mask"])
