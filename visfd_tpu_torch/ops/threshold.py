"""Intensity-mapping (threshold) functions, elementwise on the
tensor's device.

Port of ``visfd_tpu/ops/threshold.py`` (``lib/threshold/threshold.hpp:
9-258``): ``threshold2`` (a linear ramp, its direction set by the order
of the arguments), ``threshold4`` (a trapezoid or an inverted one),
``select_intensity_range`` (a binary band) and its Gaussian variant.
"""

from __future__ import annotations

import torch


def _is_between(x, a, b):
    """((a <= x) & (x < b)) | ((b < x) & (x <= a)), whichever of a, b is
    larger (``threshold.hpp:9-12``)."""
    return ((a <= x) & (x < b)) | ((b < x) & (x <= a))


def div_rounded(v, d):
    """v / d rounded once on every device: torch multiplies a CUDA tensor
    divided by a Python number by the number's reciprocal, so the divisor
    goes in as a tensor."""
    return v / torch.tensor(d, dtype=v.dtype, device=v.device)


def threshold2(x, thresh_a, thresh_b, out_a=0.0, out_b=1.0):
    """A linear ramp from 0 at thresh_a to 1 at thresh_b (decreasing when
    thresh_b < thresh_a), mapped onto [out_a, out_b]
    (``threshold.hpp:52-76``)."""
    ramp = div_rounded(x - thresh_a, thresh_b - thresh_a)
    above = (x - thresh_a) * (thresh_b - thresh_a) > 0.0
    g = torch.where(_is_between(x, thresh_a, thresh_b), ramp,
                    torch.where(above, 1.0, 0.0))
    return out_a + g * (out_b - out_a)


def threshold4(x, t01a, t01b, t10a, t10b, out_a=0.0, out_b=1.0):
    """A trapezoid 0 -> 1 -> 0 over (t01a, t01b, t10a, t10b), or the
    inverted 1 -> 0 -> 1 one when they decrease
    (``threshold.hpp:113-166``); t01b == t10a == t10b is ``threshold2``."""
    if t01b == t10a and t01b == t10b:
        return threshold2(x, t01a, t01b, out_a, out_b)
    ramp01 = div_rounded(x - t01a, t01b - t01a)
    ramp10 = div_rounded(x - t10a, t10b - t10a)
    if t01b <= t10a:
        plateau = torch.where(_is_between(x, t01b, t10a), 1.0, 0.0)
    elif t10b <= t01a:
        plateau = torch.where(_is_between(x, t10b, t01a), 0.0, 1.0)
    else:
        raise ValueError("threshold4 arguments must be monotonic")
    g = torch.where(_is_between(x, t01a, t01b), ramp01,
                    torch.where(_is_between(x, t10a, t10b), ramp10, plateau))
    return out_a + g * (out_b - out_a)


def select_intensity_range(x, range_a, range_b, out_a=0.0, out_b=1.0):
    """A binary band: 1 inside [range_a, range_b), 0 outside; swapped
    arguments invert it (``threshold.hpp:171-216``).  As in the
    reference, out_a and out_b do not remap the result."""
    if range_a < range_b:
        return torch.where(_is_between(x, range_a, range_b), 1.0, 0.0)
    return torch.where(_is_between(x, range_b, range_a), 0.0, 1.0)


def select_intensity_range_gauss(x, x0, sigma, out_a=0.0, out_b=1.0):
    """A soft band: an unnormalised Gaussian bump at x0
    (``threshold.hpp:237-258``)."""
    xr = div_rounded(x - x0, sigma)
    return out_a + (out_b - out_a) * torch.exp(-0.5 * xr * xr)
