"""Voxelwise symmetric 3x3 eigen stages: the CUDA kernels
(``csrc/eigen.cu``), their plain PyTorch twins, and the wrappers that
pick one by the tensor's device.

Port of ``visfd_tpu/ops/eigen_pallas.py``:

* ``hessian_principal``: blurred volume -> FD Hessian x sigma^2 ->
  principal eigensolve -> score (+ principal eigenvector), the faces
  replicating the nearest interior voxel.  Twin: ``hessian_fd`` ->
  ``principal_sym3`` -> score.
* ``hessian_principal_block``: the same on one block of a ``-mesh``
  run, read in place, with its 1-deep halos in four slabs cut from the
  neighbouring blocks (the per-shard mode); z and y are not clamped,
  x (never split) is; ``clamp_faces`` replicates the global faces on
  the assembled result.  ``hessian_principal_prepadded`` takes the JAX
  package's per-shard interface, a block padded by its halos, and
  launches the same kernel on views of it.  Twin: the padded block ->
  ``hessian_fd_padded`` -> x faces clamped -> ``principal_sym3`` ->
  score.
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
        out = _hessian_cuda(blur, sigma, decreasing, formula, want_v)
        hessian_principal.launches += 1
    return _split(out, formula, want_v)


hessian_principal.launches = 0


def _hessian_out(t: torch.Tensor, out_shape, formula: str,
                 want_v: bool) -> torch.Tensor:
    n_out = _n_score_channels(formula) + (3 if want_v else 0)
    return torch.empty((n_out,) + tuple(out_shape), dtype=torch.float32,
                       device=t.device)


def _hessian_cuda(blur, sigma, decreasing, formula, want_v) -> torch.Tensor:
    """Launch the single-device kernel into a fresh (n_out, Z, Y, X)
    block."""
    blur = _check_cuda("hessian_principal", blur, 3)
    out = _hessian_out(blur, blur.shape, formula, want_v)
    with torch.cuda.device(blur.device):
        cb.check(cb.library().visfd_hessian_principal(
            blur.data_ptr(), out.data_ptr(), *blur.shape,
            float(sigma) * float(sigma), int(decreasing),
            _FORMULAS.index(formula), int(want_v), cb.stream_of(blur)),
            "visfd_hessian_principal")
    return out


def _pad_halos(block, z_lo, z_hi, y_lo, y_hi) -> torch.Tensor:
    """The (Z+2, Y+2, X+2) block padded by its halo slabs, zeros in x."""
    mid = torch.cat([y_lo[:, None], block, y_hi[:, None]], dim=1)
    return torch.nn.functional.pad(
        torch.cat([z_lo[None], mid, z_hi[None]]), (1, 1))


def hessian_principal_block_plain(block, z_lo, z_hi, y_lo, y_hi,
                                  sigma: float, decreasing: bool = True,
                                  formula: str = "planar",
                                  want_v: bool = True) -> torch.Tensor:
    """The twin of the per-shard mode: the raw (n_out, Z, Y, X) block."""
    hess = hessian_fd_padded(_pad_halos(block, z_lo, z_hi, y_lo, y_hi))
    nx = block.shape[2]
    hess = hess.index_select(2, torch.arange(nx, device=hess.device)
                             .clamp(1, nx - 2))
    return _solve_plain(hess * (float(sigma) * float(sigma)), decreasing,
                        formula, want_v)


def hessian_principal_block(
    block: torch.Tensor,          # (Z, Y, X), read in place
    z_lo: torch.Tensor,           # (Y+2, X): the plane below, corners too
    z_hi: torch.Tensor,           # (Y+2, X): the plane above
    y_lo: torch.Tensor,           # (Z, X): the rows before the block in y
    y_hi: torch.Tensor,           # (Z, X): the rows after it
    sigma: float,
    decreasing: bool = True,
    formula: str = "planar",
    want_v: bool = True,
) -> torch.Tensor:
    """Per-shard entry of a mesh run (the counterpart of
    ``hessian_principal_pallas_prepadded``): the fused FD Hessian +
    eigensolve + score over one block, read in place, whose 1-deep halos
    are the four slabs (zeros beyond the global volume).  Rows of the
    slabs run along x; z_lo and z_hi hold the y-corner rows at their
    first and last row.  The z and y faces are not clamped (the caller
    replicates the global faces on the assembled result,
    ``clamp_faces``); x, which a mesh never splits, is clamped as
    ``hessian_principal`` clamps it.  Any tensor may be a strided view
    whose x stride is 1.  Returns the raw channel-stacked (n_out, Z, Y,
    X) block."""
    nz, ny, nx = block.shape if block.ndim == 3 else (0, 0, 0)
    shapes = [tuple(t.shape) for t in (z_lo, z_hi, y_lo, y_hi)]
    if (block.ndim != 3 or min(nz, ny) < 1 or nx < 3
            or shapes != [(ny + 2, nx)] * 2 + [(nz, nx)] * 2):
        raise ValueError("hessian_principal_block needs a (Z, Y, X) block "
                         "with X >= 3, (Y+2, X) z halos and (Z, X) y halos, "
                         f"got {tuple(block.shape)} and {shapes}")
    ts = (block, z_lo, z_hi, y_lo, y_hi)
    if block.device.type == "cpu":
        return hessian_principal_block_plain(*ts, sigma, decreasing, formula,
                                             want_v)
    for t in ts:
        if t.device != block.device or t.dtype != torch.float32:
            raise ValueError("hessian_principal_block takes float32 tensors "
                             f"on one device, got {t.dtype} on {t.device} "
                             f"beside {block.device}")
    # the kernel walks rows along x: each row must be contiguous
    b, zl, zh, yl, yh = (t if t.stride(-1) == 1 else t.contiguous()
                         for t in ts)
    out = _hessian_out(b, b.shape, formula, want_v)
    with torch.cuda.device(b.device):
        cb.check(cb.library().visfd_hessian_principal_block(
            b.data_ptr(), b.stride(0), b.stride(1),
            zl.data_ptr(), zl.stride(0), zh.data_ptr(), zh.stride(0),
            yl.data_ptr(), yl.stride(0), yh.data_ptr(), yh.stride(0),
            out.data_ptr(), nz, ny, nx, float(sigma) * float(sigma),
            int(decreasing), _FORMULAS.index(formula), int(want_v),
            cb.stream_of(block)), "visfd_hessian_principal_block")
    hessian_principal_block.launches += 1
    return out


hessian_principal_block.launches = 0


def _halo_views(blur_pad: torch.Tensor):
    """(block, z_lo, z_hi, y_lo, y_hi) as views of a block padded by its
    1-deep halos (the x halo columns are not read)."""
    return (blur_pad[1:-1, 1:-1, 1:-1], blur_pad[0, :, 1:-1],
            blur_pad[-1, :, 1:-1], blur_pad[1:-1, 0, 1:-1],
            blur_pad[1:-1, -1, 1:-1])


def hessian_principal_prepadded(
    blur_pad: torch.Tensor,       # (Z+2, Y+2, X+2), halos filled
    sigma: float,
    decreasing: bool = True,
    formula: str = "planar",
    want_v: bool = True,
) -> torch.Tensor:
    """The per-shard entry with the JAX package's interface
    (``hessian_principal_pallas_prepadded``): ``hessian_principal_block``
    on views of a block padded by its 1-deep halos, so nothing is
    copied.  Unlike the JAX kernel it clamps x instead of reading the x
    halo columns (a mesh never splits x; the JAX package replicates the
    x faces afterwards, to the same result).  Returns the raw
    channel-stacked (n_out, Z, Y, X) block."""
    if blur_pad.ndim != 3 or min(blur_pad.shape) < 3:
        raise ValueError("hessian_principal_prepadded needs a (Z+2, Y+2, "
                         f"X+2) block, got {tuple(blur_pad.shape)}")
    return hessian_principal_block(*_halo_views(blur_pad), sigma, decreasing,
                                   formula, want_v)


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
