"""Seconds a tomogram in ``ops/draw.draw_spheres``: stage "draw spheres"."""

from portbench.metrics import _stages as _S


def read(ctx):
    return _S.mean_stages(ctx, ["draw spheres"])
