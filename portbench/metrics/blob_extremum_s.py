"""Seconds a tomogram in ``features/blob._scale_candidates``: spans
"blob: extremum test", "blob: compaction + copy" and "blob: candidate
merge"."""

from portbench.metrics import _stages as _S


def read(ctx):
    return _S.mean_spans(ctx, ["blob: extremum test",
                               "blob: compaction + copy",
                               "blob: candidate merge"])
