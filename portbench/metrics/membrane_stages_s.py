"""Seconds a tomogram in the membrane path's device stages, between the
copies: the blur, Hessian and eigensolve (``ops/blur_cuda``,
``ops/eigen_cuda.hessian_principal``), the -tv-best threshold
(``parallel/reduce.fraction_threshold``), the voting (``ops/tv_cuda``)
and the vote's eigen score (``ops/eigen_cuda.sym3_score``)."""

from portbench.metrics import _stages as _S


def read(ctx):
    return _S.mean_stages(ctx, [
        "gaussian blur + hessian + eigendecomposition", "-tv-best threshold",
        "dense stick tensor voting", "eigen score of the vote tensor"])
