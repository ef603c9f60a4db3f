"""The share, in %, of ``roofline/hessian_eigen.py``'s bound in the traced time
of its kernel."""

from portbench import roofline


def read(ctx):
    return roofline.share(ctx, "hessian_eigen")
