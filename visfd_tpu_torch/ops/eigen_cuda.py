"""Voxelwise symmetric 3x3 eigen stages: the CUDA kernels
(``csrc/eigen.cu``), their plain PyTorch twins, and the wrappers that
pick one by the tensor's device.

Port of ``visfd_tpu/ops/eigen_pallas.py``:

* ``hessian_principal``: blurred volume -> FD Hessian x sigma^2 ->
  principal eigensolve -> score (+ principal eigenvector), the faces
  replicating the nearest interior voxel.  Twin: ``hessian_fd`` ->
  ``principal_sym3`` -> score.
* ``hessian_principal_prepadded``: the same on a block whose 1-deep
  halos the caller filled (the per-shard mode of a ``-mesh`` run), with
  no face clamp; ``clamp_faces`` replicates the global faces on the
  assembled result.  Twin: ``hessian_fd_padded`` -> ``principal_sym3``
  -> score.
* ``sym3_score``: channel-major (6, Z, Y, X) symmetric field -> eigen
  score (+ principal eigenvector).  Twin: ``principal_sym3`` -> score.

Outputs are channel-major.  Eigenvector sign is free (every consumer is
sign-invariant); compare vectors up to sign.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from visfd_tpu_torch import _cuda_build as cb
from visfd_tpu_torch.features.hessian import hessian_fd, hessian_fd_padded
from visfd_tpu_torch.linalg import sym3

_FORMULAS = ("planar", "linear", "stick", "vals")


def _n_score_channels(formula: str) -> int:
    if formula not in _FORMULAS:
        raise ValueError(f"formula must be one of {_FORMULAS}")
    return 3 if formula == "vals" else 1


def _score_channels(vals: torch.Tensor, formula: str):
    """Score channel(s) from channel-last eigenvalues (..., 3) in the
    requested order."""
    e0, e1, e2 = vals.unbind(-1)
    if formula == "planar":
        n = e0 * e0 - e1 * e1
        return [n * n]
    if formula == "linear":
        return [e0 * e1 - e2 * e2]
    if formula == "stick":
        return [e0 - e1]
    return [e0, e1, e2]


def _split(out: torch.Tensor, formula: str, want_v: bool):
    n_s = _n_score_channels(formula)
    score = out[0] if n_s == 1 else out[:n_s]
    return score, (out[n_s:n_s + 3] if want_v else None)


def _solve_plain(t6_last: torch.Tensor, decreasing: bool, formula: str,
                 want_v: bool) -> torch.Tensor:
    order = (sym3.EigenOrder.DECREASING if decreasing
             else sym3.EigenOrder.INCREASING)
    vals, v = sym3.principal_sym3(sym3.flat_to_full(t6_last), order=order)
    chans = _score_channels(vals, formula)
    if want_v:
        chans += list(v.unbind(-1))
    return torch.stack(chans)


def _check_cuda(name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
    if t.device.type != "cuda" or t.dtype != torch.float32 or t.ndim != ndim:
        raise ValueError(f"{name} takes a {ndim}-D float32 CPU or CUDA "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def hessian_principal_plain(blur: torch.Tensor, sigma: float,
                            decreasing: bool = True,
                            formula: str = "planar",
                            want_v: bool = True) -> torch.Tensor:
    """The twin of the Hessian kernel: the raw (n_out, Z, Y, X) block."""
    hess = hessian_fd(blur) * (float(sigma) * float(sigma))
    return _solve_plain(hess, decreasing, formula, want_v)


def hessian_principal(
    blur: torch.Tensor,           # (Z, Y, X) blurred volume
    sigma: float,
    decreasing: bool = True,
    formula: str = "planar",
    want_v: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused FD Hessian (x sigma^2) + principal eigensolve + score.

    Returns (score, v): score is (Z, Y, X), or (3, Z, Y, X) eigenvalues
    for formula "vals"; v is the (3, Z, Y, X) principal eigenvector or
    None.  Every dim must be >= 3."""
    if blur.ndim != 3 or min(blur.shape) < 3:
        raise ValueError("hessian_principal needs a (Z, Y, X) volume with "
                         f"every dim >= 3, got {tuple(blur.shape)}")
    if blur.device.type == "cpu":
        out = hessian_principal_plain(blur, sigma, decreasing, formula,
                                      want_v)
    else:
        out = _hessian_cuda(hessian_principal, "visfd_hessian_principal",
                            blur, blur.shape, sigma, decreasing, formula,
                            want_v)
    return _split(out, formula, want_v)


hessian_principal.launches = 0


def _hessian_cuda(wrapper, entry, blur, out_shape, sigma, decreasing,
                  formula, want_v) -> torch.Tensor:
    """Launch the C ``entry`` on a CUDA tensor into a fresh (n_out,
    *out_shape) block and count the launch on ``wrapper``."""
    blur = _check_cuda(wrapper.__name__, blur, 3)
    nz, ny, nx = out_shape
    n_out = _n_score_channels(formula) + (3 if want_v else 0)
    out = torch.empty((n_out, nz, ny, nx), dtype=torch.float32,
                      device=blur.device)
    with torch.cuda.device(blur.device):
        cb.check(getattr(cb.library(), entry)(
            blur.data_ptr(), out.data_ptr(), nz, ny, nx,
            float(sigma) * float(sigma), int(decreasing),
            _FORMULAS.index(formula), int(want_v), cb.stream_of(blur)),
            entry)
    wrapper.launches += 1
    return out


def hessian_principal_prepadded_plain(blur_pad: torch.Tensor, sigma: float,
                                      decreasing: bool = True,
                                      formula: str = "planar",
                                      want_v: bool = True) -> torch.Tensor:
    """The twin of the per-shard mode: the raw (n_out, Z, Y, X) block."""
    hess = hessian_fd_padded(blur_pad) * (float(sigma) * float(sigma))
    return _solve_plain(hess, decreasing, formula, want_v)


def hessian_principal_prepadded(
    blur_pad: torch.Tensor,       # (Z+2, Y+2, X+2), halos filled
    sigma: float,
    decreasing: bool = True,
    formula: str = "planar",
    want_v: bool = True,
) -> torch.Tensor:
    """Per-shard entry of a mesh run (``hessian_principal_pallas_
    prepadded``): the fused FD Hessian + eigensolve + score over a block
    whose 1-deep halos the caller filled, faces not clamped.  Returns
    the raw channel-stacked (n_out, Z, Y, X) block; the caller
    replicates the global faces on the assembled volume
    (``clamp_faces``)."""
    if blur_pad.ndim != 3 or min(blur_pad.shape) < 3:
        raise ValueError("hessian_principal_prepadded needs a (Z+2, Y+2, "
                         f"X+2) block, got {tuple(blur_pad.shape)}")
    if blur_pad.device.type == "cpu":
        return hessian_principal_prepadded_plain(blur_pad, sigma, decreasing,
                                                 formula, want_v)
    return _hessian_cuda(hessian_principal_prepadded,
                         "visfd_hessian_principal_prepadded", blur_pad,
                         tuple(d - 2 for d in blur_pad.shape), sigma,
                         decreasing, formula, want_v)


hessian_principal_prepadded.launches = 0


def clamp_faces(arr: torch.Tensor) -> torch.Tensor:
    """Replicate the nearest-interior value onto the faces of the
    trailing (Z, Y, X) axes, in place: x, then y, then z, so the corners
    take the fully clamped stencil (the same floats as
    ``hessian_principal``).  Returns ``arr``."""
    for axis in (-1, -2, -3):
        n = arr.shape[axis]
        arr.select(axis, 0).copy_(arr.select(axis, 1))
        arr.select(axis, n - 1).copy_(arr.select(axis, n - 2))
    return arr


def sym3_score_plain(t6: torch.Tensor, decreasing: bool = True,
                     formula: str = "stick",
                     want_v: bool = False) -> torch.Tensor:
    """The twin of the vote-tensor kernel: the raw (n_out, Z, Y, X)
    block."""
    return _solve_plain(torch.movedim(t6, 0, -1), decreasing, formula,
                        want_v)


def sym3_score(
    t6: torch.Tensor,             # (6, Z, Y, X) channel-major flat sym
    decreasing: bool = True,
    formula: str = "stick",
    want_v: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Voxelwise eigen score of a channel-major symmetric tensor field
    (the raw vote accumulator of the TV kernel).  Returns (score, v)
    with the conventions of ``hessian_principal``."""
    n_out = _n_score_channels(formula) + (3 if want_v else 0)
    if t6.ndim != 4 or t6.shape[0] != 6:
        raise ValueError("t6 must be channel-major (6, Z, Y, X)")
    if t6.device.type == "cpu":
        return _split(sym3_score_plain(t6, decreasing, formula, want_v),
                      formula, want_v)
    t6 = _check_cuda("sym3_score", t6, 4)
    nvox = t6[0].numel()
    out = torch.empty((n_out,) + tuple(t6.shape[1:]), dtype=torch.float32,
                      device=t6.device)
    if nvox:
        with torch.cuda.device(t6.device):
            cb.check(cb.library().visfd_sym3_score(
                t6.data_ptr(), out.data_ptr(), nvox, int(decreasing),
                _FORMULAS.index(formula), int(want_v), cb.stream_of(t6)),
                "visfd_sym3_score")
        sym3_score.launches += 1
    return _split(out, formula, want_v)


sym3_score.launches = 0
