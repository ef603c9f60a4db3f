"""Separable 3-D convolution: the CUDA kernel (``csrc/blur.cu``), its
plain PyTorch twin, and the wrapper that picks one by the tensor's
device.

Port of ``visfd_tpu/ops/blur_pallas.py`` (``blur3_pallas``).  Semantics
of ``ops.conv._sep3``: true convolution g[i] = sum_j h[j] f[i-j] along
z, then y, then x, with zero padding; the 1-D kernels are runtime
values of odd length.
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


def blur3(x: torch.Tensor, kernels_xyz: Sequence) -> torch.Tensor:
    """Separable 3-D convolution of a (Z, Y, X) float32 volume with the
    1-D kernels (kx, ky, kz).  A CPU tensor takes the plain twin; a
    CUDA tensor launches ``csrc/blur.cu`` (one launch per axis)."""
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
    x = x.contiguous()
    if x.numel() == 0:
        return torch.empty_like(x)
    lib = cb.library()
    nz, ny, nx = x.shape
    kx, ky, kz = ks
    taps = torch.cat([kz, ky, kx]).contiguous()
    tmp = torch.empty_like(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = cb.stream_of(x)
        # z: x -> out, y: out -> tmp, x: tmp -> out
        off = 0
        for axis, k, src, dst in ((0, kz, x, out), (1, ky, out, tmp),
                                  (2, kx, tmp, out)):
            cb.check(lib.visfd_conv1d_axis(
                src.data_ptr(), dst.data_ptr(),
                taps.data_ptr() + 4 * off, k.shape[0] // 2,
                nz, ny, nx, axis, stream), "visfd_conv1d_axis")
            off += k.shape[0]
    blur3.launches += 1
    return out


blur3.launches = 0
