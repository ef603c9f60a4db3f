"""``torch.cuda.max_memory_allocated()`` over the window (its peak
statistics reset at the window's start), in GiB."""


def read(ctx):
    return ctx.card_peak_bytes / 2 ** 30
