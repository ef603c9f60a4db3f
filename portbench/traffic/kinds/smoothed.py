"""The ``smoothed`` phantom kind: another phantom as a user hands it on
after blurring it with ``filter_mrc -gauss``, as before a watershed,
which on a raw tomogram would segment the noise.

``{"kind": "smoothed", "of": {<any phantom>}, "sigma_A": <float>}``:
the phantom ``of`` made by ``phantoms.make`` from the same seed, blurred
by the reference's 1-D Gaussian of sigma ``sigma_A / voxel_width``
voxels along z, y and x, zero padded, and divided by the same blur of
an all-ones volume (``-gauss``'s normalisation near the boundaries).
The halfwidth is ``-gauss``'s under the CLI's default truncation
(``-truncate-threshold 0.03``): floor(sigma * sqrt(-2 ln 0.03)) voxels,
at least 1 (``filter3d.hpp:1240-1247``).  The mask is the wrapped
phantom's, unchanged; the volume is float32."""

from __future__ import annotations

import math

import torch

from portbench.harness import plain
from portbench.traffic import phantoms

TRUNCATE_THRESHOLD = 0.03


def halfwidth(sigma: float) -> int:
    return max(1, int(math.floor(sigma * plain.truncate_ratio(
        TRUNCATE_THRESHOLD))))


def make(phantom, shape_zyx, voxel_width: float, seed: int, device):
    vol, mask = phantoms.make({"phantom": phantom["of"]}, shape_zyx,
                              voxel_width, seed, device)
    sigma = phantom["sigma_A"] / voxel_width
    k = plain.gauss_kernel_1d(sigma, halfwidth(sigma))
    vol = plain.blur3(vol, k) / plain.edge_denominator(
        k, shape_zyx, torch.float32, device)
    return vol.to(torch.float32), mask
