"""Seconds a tomogram in ``features/blob.sort_blobs`` and
``io/coords.write_blob_coords_file`` of the ``-blob`` lists: stage
"write the blob lists"."""

from portbench.metrics import _stages as _S


def read(ctx):
    return _S.mean_stages(ctx, ["write the blob lists"])
