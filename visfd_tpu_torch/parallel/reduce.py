"""Global statistics and the ``-tv-best`` threshold, on one device or
over the blocks of a sharded volume.

Port of ``visfd_tpu/parallel/reduce.py`` (``handlers.cpp:1753-1797``:
sort the in-mask saliencies descending and take entry
``min(floor(n * fraction), n - 1)``).

* One device: a sort of the in-mask values gives that entry bit for
  bit.  (``torch.sort`` and not ``torch.kthvalue``: on the card
  kthvalue selects a single slice with one thread block: 486 ms against
  3.5 ms for the sort, 67M voxels, on an H100 80GB HBM3 at 700 W; the
  sort's launches show in a traced run of the membrane cell,
  ``portbench/run.py --trace 1``.)
* A ``ShardedVolume``: the exact k-th largest by 4 rounds of a 256-bin
  radix histogram over an order-preserving 32-bit key, as the JAX
  package does with ``psum``: each block counts its own keys
  (``torch.bincount``), the 256 counts are summed on the host, and the
  target bin pins the next byte.  No block is gathered or sorted.

Across the ranks of a multi-process cluster (``parallel.distributed``)
the counts are all-reduced as int64, so ``-tv-best`` keeps the same
threshold bit for bit, and ``global_min_max_mean`` folds every block's
(min, max, float64 sum, count), all-gathered, in z-major block order,
so its mean does not depend on how the blocks are spread over ranks.
Every rank calls these functions on a volume that spans ranks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from visfd_tpu_torch.parallel import distributed as D
from visfd_tpu_torch.parallel.mesh import Mesh, ShardedVolume, shard


def _ordered_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 bit pattern whose unsigned order is the float
    order (sign-flip trick; -0.0 < +0.0).  Bytes are read from it with
    ``(key >> shift) & 0xFF``, so its sign bit does no harm."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b < 0, ~b, b ^ torch.iinfo(torch.int32).min)


def _from_key(key: int) -> float:
    """The float32 whose ordered key is the unsigned 32-bit ``key``."""
    b = key ^ 0x80000000 if key >= 0x80000000 else ~key & 0xFFFFFFFF
    return float(np.array([b], np.uint32).view(np.float32)[0])


def _blocks(x, mask) -> list:
    """[(values, valid)] per block of ``x`` (a tensor or a
    ShardedVolume); ``valid`` is None when every voxel counts."""
    if isinstance(x, ShardedVolume):
        return [(b, None if mask is None else mask.blocks[iz][iy] != 0)
                for iz, iy, b in x.cells()]
    return [(x, None if mask is None else mask != 0)]


def _spans(x) -> bool:
    return isinstance(x, ShardedVolume) and x.mesh.spans_processes


def count_valid(x, mask=None) -> int:
    """The number of in-mask voxels of ``x``."""
    n = sum(int(v.numel() if ok is None else ok.sum())
            for v, ok in _blocks(x, mask))
    return int(D.allreduce_sum(np.int64(n))) if _spans(x) else n


def global_min_max_mean(x, mask=None) -> Tuple[float, float, float]:
    """(min, max, mean) over the in-mask voxels (``MrcSimple::
    FindMinMaxMean``, ``mrc_simple.hpp:100-121``); the sum is taken in
    float64, block by block in z-major order."""
    cells = (list(x.cells()) if isinstance(x, ShardedVolume)
             else [(0, 0, x)])
    stats = []      # (cell, min, max, sum, count) of each non-empty block
    for (iz, iy, _), (v, ok) in zip(cells, _blocks(x, mask)):
        vals = v.reshape(-1) if ok is None else v[ok]
        if vals.numel():
            stats.append((iz * 65536 + iy, float(vals.min()),
                          float(vals.max()), float(vals.double().sum()),
                          vals.numel()))
    stats = np.asarray(stats, np.float64).reshape(-1, 5)
    if _spans(x):
        stats = D.allgather_concat(stats)
        stats = stats[np.argsort(stats[:, 0], kind="stable")]
    vmin, vmax, vsum, cnt = np.inf, -np.inf, 0.0, 0
    for _, lo, hi, total, n in stats:
        vmin, vmax = min(vmin, lo), max(vmax, hi)
        vsum += total
        cnt += int(n)
    return vmin, vmax, vsum / max(cnt, 1)


def kth_largest(x, k: int, mask=None) -> float:
    """The exact k-th largest in-mask value (0-based, duplicates
    counted), as ``np.sort(vals)[::-1][k]``, by radix selection over the
    blocks."""
    keys = [(_ordered_key(v.to(torch.float32)), ok) for v, ok in _blocks(
        x, mask)]
    match = [ok for _, ok in keys]   # None: every voxel still matches
    prefix, kk = 0, int(k)
    for shift in (24, 16, 8, 0):
        bytes_, hists = [], []
        for (key, _), m in zip(keys, match):
            byte = (key >> shift) & 0xFF
            # out-of-prefix voxels go to bin 256, which is dropped
            idx = byte if m is None else torch.where(m, byte, 256)
            hists.append(torch.bincount(idx.reshape(-1), minlength=257))
            bytes_.append(byte)
        # every block's count is queued before the first is read back
        hist = sum(h[:256].cpu().numpy() for h in hists)
        if _spans(x):
            hist = D.allreduce_sum(hist.astype(np.int64))
        # c[b] = count with byte >= b; the target bin is the largest b
        # with c[b] > kk
        c = np.cumsum(hist[::-1])[::-1]
        b = int(np.clip(np.sum(c > kk) - 1, 0, 255))
        kk -= int(c[b] - hist[b])
        prefix |= b << shift
        match = [(byte == b) if m is None else (m & (byte == b))
                 for byte, m in zip(bytes_, match)]
    return _from_key(prefix)


def fraction_threshold(
    score,
    fraction: float,
    mesh: Optional[Mesh] = None,
    mask=None,
) -> float:
    """The in-mask value at 0-based position
    ``k = min(floor(n * fraction), n - 1)`` of the descending order,
    i.e. ``np.sort(vals)[::-1][k]``; 0.0 when no voxel is in the mask.
    A ShardedVolume ``score`` (or a tensor with a ``mesh`` to shard it
    over) takes the radix selection, a tensor on one device the sort."""
    if mesh is not None and not isinstance(score, ShardedVolume):
        score = shard(score, mesh)
        mask = None if mask is None else shard(mask, mesh)
    n = count_valid(score, mask)
    if n == 0:
        return 0.0
    k = min(int(np.floor(n * fraction)), n - 1)
    if isinstance(score, ShardedVolume):
        return kth_largest(score, k, mask)
    vals = score.reshape(-1) if mask is None else score[mask != 0]
    # the k-th largest (0-based) is entry n - 1 - k of the ascending order
    return float(torch.sort(vals.to(torch.float32)).values[n - 1 - k])
