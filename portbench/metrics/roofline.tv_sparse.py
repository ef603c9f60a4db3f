"""The share, in %, of ``roofline/tv_sparse.py``'s bound in the traced time
of its kernel."""

from portbench import roofline


def read(ctx):
    return roofline.share(ctx, "tv_sparse")
