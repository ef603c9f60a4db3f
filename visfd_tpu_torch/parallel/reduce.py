"""The ``-tv-best`` top-fraction threshold on one device.

Port of ``fraction_threshold`` from ``visfd_tpu/parallel/reduce.py``
(``handlers.cpp:1753-1797``): sort the in-mask saliencies descending
and take entry ``min(floor(n * fraction), n - 1)``.  The JAX package
computes it as a distributed radix selection; on one device a sort of
the in-mask values gives the same value, bit for bit.  (``torch.sort``
and not ``torch.kthvalue``: on the card kthvalue selects a single slice
with one thread block: 486 ms against 3.5 ms for the sort, 67M voxels,
on an H100 80GB HBM3 at 700 W, ``profile_main_path.py``.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def fraction_threshold(
    score: torch.Tensor,
    fraction: float,
    mask: Optional[torch.Tensor] = None,
) -> float:
    """The in-mask value at 0-based position
    ``k = min(floor(n * fraction), n - 1)`` of the descending order,
    i.e. ``np.sort(vals)[::-1][k]``; 0.0 when no voxel is in the mask."""
    vals = score.reshape(-1) if mask is None else score[mask != 0]
    n = vals.numel()
    if n == 0:
        return 0.0
    k = min(int(np.floor(n * fraction)), n - 1)
    # the k-th largest (0-based) is entry n - 1 - k of the ascending order
    return float(torch.sort(vals.to(torch.float32)).values[n - 1 - k])
