"""Dense 3-D correlation with zero padding: the CUDA kernel
(``csrc/conv3d.cu``), its plain PyTorch twin, and the wrapper that picks
one by the tensor's device.

The JAX package computes its dense convolutions in XLA
(``visfd_tpu/ops/conv.py:_dense_conv3d_impl``, ``conv_general_dilated``
at ``Precision.HIGHEST``).  Here ``conv3d_dense`` takes the kernel
already flipped (``ops.conv.dense_conv3d`` flips it): out[p] = sum over
the taps t, in ascending (z, y, x) order, of k[t] * x[p - h + t], zero
outside the volume.  Both the kernel and the twin sum in that order
with no reordering that depends on the volume's shape, so a block of a
``-mesh`` run read with a deep enough halo gives its interior the
single-device values bit for bit (the kernel fuses each product into
its sum, the twin does not: the tolerances cover that).
"""

from __future__ import annotations

import torch

from visfd_tpu_torch import _cuda_build as cb


def conv3d_dense_plain(x: torch.Tensor, kflip: torch.Tensor) -> torch.Tensor:
    """The twin: a sum of shifted copies of the zero-padded volume, one
    per tap, in the kernel's order."""
    kz, ky, kx = kflip.shape
    hz, hy, hx = kz // 2, ky // 2, kx // 2
    nz, ny, nx = x.shape
    xp = torch.nn.functional.pad(x, (hx, hx, hy, hy, hz, hz))
    out = torch.zeros_like(x)
    taps = kflip.tolist()
    for a in range(kz):
        for b in range(ky):
            for c in range(kx):
                out += xp[a:a + nz, b:b + ny, c:c + nx] * taps[a][b][c]
    return out


def conv3d_dense(x: torch.Tensor, kflip) -> torch.Tensor:
    """Dense correlation of a (Z, Y, X) float32 volume with the odd-sided
    (flipped) kernel ``kflip``.  A CPU tensor takes the plain twin; a
    CUDA tensor launches ``csrc/conv3d.cu``."""
    k = torch.as_tensor(kflip, dtype=torch.float32, device=x.device)
    if k.ndim != 3 or any(s % 2 == 0 for s in k.shape):
        raise ValueError(f"conv3d_dense takes an odd-sided 3-D kernel, got "
                         f"{tuple(k.shape)}")
    if x.device.type == "cpu":
        return conv3d_dense_plain(x, k)
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"conv3d_dense takes a (Z, Y, X) float32 CPU or "
                         f"CUDA tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    nz, ny, nx = x.shape
    if nz > 65535 or ny * nx >= 2 ** 31:
        raise ValueError(f"conv3d_dense: {tuple(x.shape)} exceeds the "
                         f"kernel's grid")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    k = k.contiguous()
    hz, hy, hx = (s // 2 for s in k.shape)
    with torch.cuda.device(x.device):
        cb.check(cb.library().visfd_conv3d(
            x.data_ptr(), out.data_ptr(), k.data_ptr(), hx, hy, hz,
            nz, ny, nx, cb.stream_of(x)), "visfd_conv3d")
    conv3d_dense.launches += 1
    return out


conv3d_dense.launches = 0
