"""Seconds a tomogram in ``_maybe_shard`` and ``parallel/gather.to_host_np``:
stages "copy the volume to the device" and "copy the result to the
host"."""

from portbench.metrics import _stages as _S


def read(ctx):
    return _S.mean_stages(ctx, ["copy the volume to the device",
                                "copy the result to the host"])
