"""GiB a tomogram copied from host to device (``Report`` count "bytes
to the device": ``_maybe_shard``, ``handle_binning``, the drawing's
uploads, ...), the mean over the window's requests; None where no
request counted any."""

NAME = "bytes to the device"


def read(ctx):
    if not any(NAME in r.counts for r in ctx.requests):
        return None
    return sum(r.counts.get(NAME, 0) for r in ctx.requests) / len(
        ctx.requests) / 2 ** 30
