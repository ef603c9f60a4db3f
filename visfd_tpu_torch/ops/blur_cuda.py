"""Separable 3-D convolution: the CUDA kernel (``csrc/blur.cu``), its
plain PyTorch twin, and the wrapper that picks one by the tensor's
device.  Halfwidths whose fused tile does not fit in shared memory take
the kernel's per-axis mode (``blur3_axis``: one launch per axis), as
the JAX package sends kernels longer than 61 taps to XLA's conv1d
(``visfd_tpu/ops/conv.py:96-103``).

Port of ``visfd_tpu/ops/blur_pallas.py`` (``blur3_pallas``).  Semantics
of ``ops.conv._sep3``: true convolution g[i] = sum_j h[j] f[i-j] along
each axis, with zero padding; the 1-D kernels are runtime values of odd
length.  The twin sums z, then y, then x; the kernel x, then y, then z
(the TPU kernel y, x, z), which the tolerances cover.
"""

from __future__ import annotations

from typing import Sequence

import torch

from visfd_tpu_torch import _cuda_build as cb


def conv1d_axis(x: torch.Tensor, kernel: torch.Tensor,
                axis: int) -> torch.Tensor:
    """1-D convolution g[i] = sum_j h[j] * f[i-j] along ``axis`` with
    zero padding, as a sum of shifted copies; kernel length is odd."""
    klen = kernel.shape[0]
    hw = klen // 2
    if hw == 0:
        return x * kernel[0]
    n = x.shape[axis]
    pad = [0, 0] * x.ndim
    # F.pad lists the last axis first
    pad[2 * (x.ndim - 1 - axis)] = hw
    pad[2 * (x.ndim - 1 - axis) + 1] = hw
    xp = torch.nn.functional.pad(x, pad)
    out = None
    for t in range(klen):
        term = xp.narrow(axis, t, n) * kernel[klen - 1 - t]
        out = term if out is None else out + term
    return out


def blur3_plain(x: torch.Tensor, kernels_xyz: Sequence) -> torch.Tensor:
    """The twin of the kernel: three shift-sum passes, z then y then x."""
    kx, ky, kz = kernels_xyz
    out = conv1d_axis(x, kz, axis=0)
    out = conv1d_axis(out, ky, axis=1)
    return conv1d_axis(out, kx, axis=2)


SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper


_STAGES = 3        # staged input planes (csrc/blur.cu)
_MAX_FIXED = 8     # one halfwidth 1-8 on every axis is compile-time
_FIXED_ROWS = 8    # its rows of threads, 4 output rows each


def smem_plan(hx: int, hy: int, hz: int):
    """(rows of threads, dynamic shared-memory bytes) of the fused kernel
    for the halfwidths (hx, hy, hz), or None when no tile fits: three
    staged (tile rows + 2hy) x (32 + 2hx) input planes and two planes of
    x-blurred rows, all float32.  One halfwidth 1-8 on every axis takes
    8 rows of threads and a 32-row tile; other widths one output row
    per thread, the most of 8, 4, 2, 1 rows that fit beside a ring of
    2hz+1 xy-blurred planes of the tile and the taps."""
    def nbytes(tile_rows, ring):
        ry, sx = tile_rows + 2 * hy, 32 + 2 * hx
        extra = (2 * hz + 1) * 32 * tile_rows + 2 * (hx + hy + hz) + 3
        return 4 * (_STAGES * ry * sx + 2 * 32 * ry + (extra if ring else 0))
    if hx == hy == hz and 1 <= hx <= _MAX_FIXED:
        return _FIXED_ROWS, nbytes(4 * _FIXED_ROWS, False)
    for rows in (8, 4, 2, 1):
        if nbytes(rows, True) <= SMEM_LIMIT:
            return rows, nbytes(rows, True)
    return None


# the largest halfwidth (on every axis) whose tile fits
MAX_KERNEL_HALFWIDTH = max(h for h in range(1, 256)
                           if smem_plan(h, h, h) is not None)


def blur3(x: torch.Tensor, kernels_xyz: Sequence) -> torch.Tensor:
    """Separable 3-D convolution of a (Z, Y, X) float32 volume with the
    1-D kernels (kx, ky, kz).  A CPU tensor takes the plain twin; a
    CUDA tensor launches ``csrc/blur.cu`` (one fused launch)."""
    ks = [torch.as_tensor(k, dtype=torch.float32, device=x.device)
          for k in kernels_xyz]
    if any(k.ndim != 1 or k.shape[0] % 2 == 0 for k in ks):
        raise ValueError("blur3 kernels must be 1-D of odd length")
    if x.device.type == "cpu":
        return blur3_plain(x, ks)
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"blur3 takes a (Z, Y, X) float32 CPU or CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    kx, ky, kz = ks
    hx, hy, hz = (k.shape[0] // 2 for k in ks)
    plan = smem_plan(hx, hy, hz)
    if plan is None:
        return blur3_axis(x, ks)
    if x.shape[1] * x.shape[2] >= 2 ** 31:
        raise ValueError(f"blur3: a plane of {tuple(x.shape[1:])} voxels "
                         f"exceeds the kernel's 32-bit plane offsets")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    nz, ny, nx = x.shape
    taps = torch.cat([kz, ky, kx]).contiguous()
    with torch.cuda.device(x.device):
        cb.check(cb.library().visfd_blur3(
            x.data_ptr(), out.data_ptr(), taps.data_ptr(), hx, hy, hz,
            nz, ny, nx, *plan, cb.stream_of(x)), "visfd_blur3")
    blur3.launches += 1
    return out


blur3.launches = 0


def blur3_axis(x: torch.Tensor, kernels_xyz: Sequence) -> torch.Tensor:
    """``blur3`` of a (Z, Y, X) float32 CUDA tensor by the kernel's
    per-axis mode: x, then y, then z, one launch each, any halfwidth
    (each output sums its taps in the fused kernel's order)."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"blur3_axis takes a (Z, Y, X) float32 CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    nz, ny, nx = x.shape
    if -(-nz * ny // 32) >= 2 ** 31 or max(nx, ny, nz) > 128 * 65535 or \
            nz > 65535 or -(-ny * nx // 32) >= 2 ** 31:
        raise ValueError(f"blur3_axis: {tuple(x.shape)} exceeds the "
                         f"kernel's grid")
    src = x.contiguous()
    if src.numel() == 0:
        return torch.empty_like(src)
    ks = [torch.as_tensor(k, dtype=torch.float32, device=x.device)
          .contiguous() for k in kernels_xyz]
    tmp = torch.empty_like(src)
    out = torch.empty_like(src)
    lib = cb.library()
    # x: src -> tmp, y: tmp -> out, z: out -> tmp
    with torch.cuda.device(x.device):
        for axis, (a, b) in ((2, (src, tmp)), (1, (tmp, out)),
                             (0, (out, tmp))):
            k = ks[2 - axis]
            cb.check(lib.visfd_blur_axis(
                a.data_ptr(), b.data_ptr(), k.data_ptr(), k.shape[0] // 2,
                nz, ny, nx, axis, cb.stream_of(x)), "visfd_blur_axis")
            blur3_axis.launches += 1
    return tmp


blur3_axis.launches = 0
