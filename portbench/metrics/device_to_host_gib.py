"""GiB a tomogram copied from device to host (``Report`` count "bytes
to the host": ``parallel/gather.to_host_np``, ``handle_binning``, the
blob candidates, ...), the mean over the window's requests; None where
no request counted any."""

NAME = "bytes to the host"


def read(ctx):
    if not any(NAME in r.counts for r in ctx.requests):
        return None
    return sum(r.counts.get(NAME, 0) for r in ctx.requests) / len(
        ctx.requests) / 2 ** 30
