"""Seconds a tomogram in ``io/mrc.write_mrc``'s header statistics (the
float64 copy, min, max and mean), inside the stage "write the
tomogram": span "mrc: header statistics"."""

from portbench.metrics import _stages as _S


def read(ctx):
    return _S.mean_spans(ctx, ["mrc: header statistics"])
