"""Seconds a tomogram in the LoG ladder (``features/blob.blob_dog`` ->
``ops/filters.apply_log`` -> ``ops/blur_cuda.blur3``): span "blob: LoG
ladder"."""

from portbench.metrics import _stages as _S


def read(ctx):
    return _S.mean_spans(ctx, ["blob: LoG ladder"])
