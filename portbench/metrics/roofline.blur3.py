"""The share, in %, of ``roofline/blur3.py``'s bound in the traced time
of its kernel."""

from portbench import roofline


def read(ctx):
    return roofline.share(ctx, "blur3")
