"""Seconds a tomogram of ``filter_mrc.run`` outside every stage: parsing,
the -mask read, ``handle_binning``'s upload and download, the
post-processing, and the return (the harness's clock around ``run``,
less the union of its stages)."""


def read(ctx):
    if not ctx.requests:
        return None
    return sum(r.wall - r.staged_seconds() for r in ctx.requests) / len(
        ctx.requests)
