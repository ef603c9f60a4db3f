"""Dense stick tensor voting (surface / curve saliency refinement).

Port of ``visfd_tpu/features/tv.py`` (``class TV3D``,
``feature.hpp:1624-2483``).  The accumulation is ``ops.tv_cuda``: the
CUDA kernel for tensors on the card, its plain twin
(``tv_accumulate_padded``) on the CPU.  This module adds the
normalisations:

* with a source mask, all 6 tensor channels divide by the accumulated
  denominator;
* WITHOUT a mask the reference divides through a full 3x3 double loop
  over the symmetric-6 storage, so the off-diagonal channels are
  divided TWICE by the separable 1-D-Gaussian box denominator
  (``feature.hpp:1840-1864``), a behaviour kept for parity.
"""

from __future__ import annotations

from typing import Optional

import torch

from visfd_tpu_torch.ops import kernels as K
from visfd_tpu_torch.ops.conv import _ones_denom_1d
from visfd_tpu_torch.ops.tv_cuda import (  # noqa: F401  (re-exported)
    tv_accumulate_padded, tv_tables, tv_votes)


def tv_dense_stick(
    saliency: torch.Tensor,       # (Z, Y, X)
    nvec: torch.Tensor,           # (Z, Y, X, 3) unit stick directions (x,y,z)
    sigma: float,
    exponent: int = 4,
    mask_src: Optional[torch.Tensor] = None,
    mask_dest: Optional[torch.Tensor] = None,
    detect_curves: bool = False,
    truncate_ratio: float = 2.5,
    normalize: bool = True,
    sparse: bool = False,
) -> torch.Tensor:
    """Stick voting; returns the (Z, Y, X, 6) vote tensors.  ``sparse``
    (kernel only) skips all-zero source planes, with the same result."""
    saliency = saliency.to(torch.float32)
    ms = None if mask_src is None else mask_src.to(torch.float32)
    md = None if mask_dest is None else mask_dest.to(torch.float32)
    want_den = bool(normalize and ms is not None)
    dest, den = tv_votes(saliency, nvec, sigma, exponent=exponent,
                         mask_src=ms, detect_curves=detect_curves,
                         truncate_ratio=truncate_ratio,
                         want_denominator=want_den, sparse=sparse,
                         nvec_channel_major=False)
    if md is not None:
        keep = md != 0
        dest = torch.where(keep[..., None], dest, 0.0)
        if den is not None:
            den = torch.where(keep, den, 0.0)

    if normalize:
        if ms is not None:
            ok = den > 0
            dest = torch.where(ok[..., None],
                               dest / torch.where(ok, den, 1.0)[..., None],
                               dest)
        else:
            _, _, hw = tv_tables(sigma, truncate_ratio)
            k1 = torch.as_tensor(K.gauss_kernel_1d(sigma, hw),
                                 dtype=torch.float32, device=dest.device)
            dz = _ones_denom_1d(k1, saliency.shape[0])[:, None, None]
            dy = _ones_denom_1d(k1, saliency.shape[1])[None, :, None]
            dx = _ones_denom_1d(k1, saliency.shape[2])[None, None, :]
            box = dz * dy * dx
            scale = torch.stack([box, box, box, box * box, box * box,
                                 box * box], dim=-1)
            dest = dest / scale
            if md is not None:
                dest = torch.where((md != 0)[..., None], dest, 0.0)
    return dest
