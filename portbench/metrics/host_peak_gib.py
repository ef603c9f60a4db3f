"""The host's peak resident memory over the window, in GiB
(``harness/hostmem``: VmHWM after a reset where the kernel allows it,
else ``/proc/self/statm`` sampled every 2 ms)."""


def read(ctx):
    return ctx.host_peak_bytes / 2 ** 30
