"""Input voxels of every request the window started, over the seconds
from the window's start to the end of the last one."""


def read(ctx):
    t0, t1 = ctx.window
    return len(ctx.requests) * ctx.voxels / (t1 - t0)
