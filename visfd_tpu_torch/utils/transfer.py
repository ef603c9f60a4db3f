"""The one place a volume crosses between host and device.

``to_device`` and ``to_host`` own the copy of every array that grows
with the volume or with the candidate count (the tomogram, the mask,
binned and drawn volumes, handler results, each z slab of a
``ShardedVolume``, candidate and extremum lists): its dtype, the
read-only file buffer it may start from (an MRC volume is a read-only
``frombuffer`` view, which ``torch.as_tensor`` warns about) and its count
in a ``Report``'s ``TO_DEVICE`` / ``TO_HOST`` bytes.  A function that
holds a ``Report`` passes it; one that has none copies uncounted.

Left as they are: kernel tap tables, scalars, per-round loop flags and
the small per-sphere, per-point and per-basin tables, which are not
counted; and the exchanges of ``parallel/distributed``, which stage the
collectives.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from visfd_tpu_torch.utils.progress import TO_DEVICE, TO_HOST, Report


def _on_host(a) -> bool:
    return not isinstance(a, torch.Tensor) or a.device.type == "cpu"


def _count_copy(report, src, dst) -> None:
    """Add ``dst``'s bytes to ``report``'s count ``TO_DEVICE`` or
    ``TO_HOST`` where exactly one of ``src`` and ``dst`` (tensors, or
    numpy arrays, which are on the host) is on the host; nothing
    otherwise, nor for a ``report`` that is not a ``Report``."""
    if isinstance(report, Report) and _on_host(src) != _on_host(dst):
        report.add_count(TO_DEVICE if _on_host(src) else TO_HOST, dst.nbytes)


def to_device(a, device, report: Optional[Report] = None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a`` on ``device`` as ``dtype`` (None keeps ``a``'s): a numpy
    array as a fresh tensor (the array only read), a tensor as
    ``Tensor.to`` moves it (itself where it is there already); the copy
    counted in ``report``."""
    if isinstance(a, torch.Tensor):
        t = a.to(device, dtype)
    else:
        t = torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    _count_copy(report, a, t)
    return t


def to_host(t, report: Optional[Report] = None, dtype=None,
            out: Optional[torch.Tensor] = None) -> np.ndarray:
    """``t`` (a tensor, or an array already on the host) as a numpy
    array on the host, converted there to ``dtype`` (None keeps its
    own); with ``out`` (a host tensor of ``t``'s shape and dtype) copied
    into it in place.  The copy counted in ``report``."""
    if out is not None:
        host = out.copy_(t).numpy()
    elif isinstance(t, torch.Tensor):
        host = t.detach().cpu().numpy()
    else:
        host = np.asarray(t)
    _count_copy(report, t, host)
    return host if dtype is None else host.astype(dtype, copy=False)
