"""The share, in %, of ``roofline/blob_extremum.py``'s bound in the traced
time of its kernel (none where the program has no such kernel)."""

from portbench import roofline


def read(ctx):
    return roofline.share(ctx, "blob_extremum")
