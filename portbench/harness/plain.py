"""Plain PyTorch and NumPy pieces that the traffic generator and the
references share: the reference's 1-D Gaussian (``filter1d.hpp:
428-460``), a zero-padded separable convolution as a sum of shifted
copies, and the truncation rules of ``filter3d.hpp``.  Nothing here
imports the program."""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import ive


def gauss_kernel_1d(sigma: float, halfwidth: int) -> np.ndarray:
    """The normalised kernel of 2 halfwidth + 1 taps, float64: the
    discrete Gaussian exp(-s^2) I_|i|(s^2) where sigma <= 10 and |i| <=
    20, the sampled continuous one elsewhere; a delta at sigma 0."""
    i = np.arange(-int(halfwidth), int(halfwidth) + 1, dtype=np.float64)
    if sigma == 0.0:
        h = (i == 0).astype(np.float64)
    else:
        s2 = float(sigma) ** 2
        discrete = ive(np.abs(i), s2)
        cont = np.exp(-(i * i) / (2.0 * s2)) / np.sqrt(2.0 * s2 * np.pi)
        h = np.where((sigma <= 10.0) & (np.abs(i) <= 20.0), discrete, cont)
    return h / h.sum()


def truncate_ratio(threshold: float) -> float:
    """The ratio of halfwidth to sigma at which a Gaussian falls to
    ``threshold`` of its peak."""
    return float(np.sqrt(-2.0 * np.log(threshold)))


def conv1d(x: torch.Tensor, kernel: torch.Tensor, axis: int) -> torch.Tensor:
    """g[i] = sum_j h[j] f[i - j] along ``axis``, zero padded: a sum of
    shifted copies of ``x`` in the kernel's order."""
    k = kernel.shape[0]
    hw = k // 2
    if hw == 0:
        return x * kernel[0]
    n = x.shape[axis]
    pad = [0, 0] * x.ndim
    pad[2 * (x.ndim - 1 - axis)] = hw
    pad[2 * (x.ndim - 1 - axis) + 1] = hw
    xp = torch.nn.functional.pad(x, pad)
    out = None
    for t in range(k):
        term = xp.narrow(axis, t, n) * kernel[k - 1 - t]
        out = term if out is None else out + term
    return out


def blur3(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """The same 1-D kernel along z, then y, then x, zero padded."""
    k = torch.as_tensor(np.asarray(kernel), dtype=x.dtype, device=x.device)
    for axis in range(3):
        x = conv1d(x, k, axis)
    return x


def edge_denominator(kernel: np.ndarray, shape, dtype, device):
    """blur3 of an all-ones volume, as the outer product of its three
    1-D factors (each the kernel's sum over the taps inside the
    volume)."""
    k = torch.as_tensor(np.asarray(kernel), dtype=dtype, device=device)
    f = [conv1d(torch.ones((1, 1, n), dtype=dtype, device=device), k, 2)[0, 0]
         for n in shape]
    return f[0][:, None, None] * f[1][None, :, None] * f[2][None, None, :]
