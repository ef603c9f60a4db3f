"""pval_mrc: Poisson p-value that the densest (or sparsest) Gaussian
bin of a particle point cloud could occur by chance.

Parity with ``bin/pval_mrc/pval_mrc.cpp:120-556``: for each sigma in
the ladder, blur the particle image (density in physical units),
locate the extreme density, and compute
``p = 1 - (1 - poisson_cdf)^num_bins`` with ``k = rho_extreme *
V_bin``, ``lambda = rho_ave * V_bin`` and ``V_bin =
1/peak(Gauss^3)`` (from the discrete-Gaussian peak height).
Prints: ``prob extreme_density ix iy iz effective_bin_size``.

Port of ``visfd_tpu/cli/pval_mrc.py``: the blur runs on ``device``
(``ops.filters.apply_gauss``, the ``csrc/blur.cu`` kernel on the card);
so does the extreme's search (the JAX tool's ``np.nanargmin`` /
``nanargmax`` with masked voxels set to NaN: here ``argmin`` / ``argmax``
with them set to +inf / -inf, ties to the first index in both); the
statistics run on the host.
"""

from __future__ import annotations

import sys
from math import exp, floor, lgamma

import numpy as np
import torch

from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.ops import kernels as K
from visfd_tpu_torch.ops.filters import apply_gauss
from visfd_tpu_torch.ops.threshold import div_rounded
from visfd_tpu_torch.utils.transfer import to_device, to_host


def poisson_cdf_below(k, lam):
    """sum_{i=0..floor(k)} lam^i e^-lam / i!  (log-stable)."""
    total = 0.0
    for i in range(int(floor(k)) + 1):
        total += exp(i * np.log(lam) - lam - lgamma(i + 1.0)) if lam > 0 \
            else (1.0 if i == 0 else 0.0)
    return total


def run(argv, device="cuda") -> int:
    """pval_mrc on ``argv`` with the blur on ``device`` (a library
    argument: the command line always uses CUDA)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("visfd_tpu_torch: no CUDA device is visible; "
                           "pval_mrc runs on an NVIDIA GPU")
    args = list(argv)
    in_name = out_name = mask_name = coords_name = ""
    voxel_width = -1.0
    a2nm = False
    sigmas = []
    num_particles = -1.0
    vol_total = -1.0
    use_min = True
    truncate_ratio = -1.0
    truncate_threshold = 0.02   # pval's own default (settings.cpp:37)
    image_size = None
    i = 0
    pos = []
    while i < len(args):
        a = args[i]
        if a in ("-in", "-i"):
            in_name = args[i + 1]; i += 1
        elif a in ("-out", "-o"):
            out_name = args[i + 1]; i += 1
        elif a == "-mask":
            mask_name = args[i + 1]; i += 1
        elif a in ("-coords", "-crds"):
            coords_name = args[i + 1]; i += 1
        elif a == "-w":
            voxel_width = float(args[i + 1]); i += 1
        elif a in ("-a2nm", "-ang-to-nm"):
            a2nm = True
        elif a == "-gauss":
            sigmas = [float(args[i + 1])]; i += 1
        elif a == "-gauss-sweep":
            smin, smax, g = (float(args[i + k]) for k in (1, 2, 3))
            n = 1 + int(np.ceil(np.log(smax / smin) / np.log(g)))
            g = (smax / smin) ** (1.0 / n)
            sigmas = [smin]
            for _ in range(1, n):
                sigmas.append(sigmas[-1] * g)
            i += 3
        elif a == "-n":
            num_particles = float(args[i + 1]); i += 1
        elif a in ("-vol", "-volume"):
            vol_total = float(args[i + 1]); i += 1
        elif a in ("-pmin", "-min", "-minima"):
            use_min = True
        elif a in ("-pmax", "-max", "-maxima"):
            use_min = False
        elif a == "-image-size":
            image_size = tuple(int(args[i + k]) for k in (1, 2, 3)); i += 3
        elif a == "-np":
            i += 1  # thread count: meaningless here
        elif a == "-truncate":
            truncate_ratio = float(args[i + 1]); i += 1
        elif a == "-truncate-threshold":
            truncate_threshold = float(args[i + 1])
            truncate_ratio = -1.0; i += 1
        elif a.startswith("-"):
            print(f"Error: unrecognized argument {a}", file=sys.stderr)
            return 1
        else:
            pos.append(a)
        i += 1
    if not in_name and pos:
        in_name = pos[0]
    if (not in_name and image_size is None) or not sigmas:
        print("Usage: pval_mrc -in f.mrc -gauss sigma [-min|-max] ...",
              file=sys.stderr)
        return 1

    if in_name:
        img = mrc.read_mrc(in_name)
        w = np.asarray(img.voxel_width_xyz)
        x = img.data
    else:
        # -image-size Nx Ny Nz with a -crds point cloud
        nx_, ny_, nz_ = image_size
        x = np.zeros((nz_, ny_, nx_), np.float32)
        img = None
        w = np.ones(3)
    if voxel_width > 0:
        w = np.full(3, voxel_width)
    if a2nm:
        w = w * 0.1
    if (w <= 0).any():
        w = np.ones(3)
    mask = mrc.read_mrc(mask_name).data if mask_name else None
    if coords_name:
        # the reference consumes the file as a RAW WHITESPACE STREAM
        # of floats in triples (pval_mrc.cpp:130-143) -- not per line.
        # Multi-column files (e.g. blob lists with diameter+score)
        # therefore yield extra "points", and C++ stream semantics
        # plant one more point with stale components when the token
        # count is not a multiple of 3.  Replicated exactly.
        x = np.zeros_like(x)
        vals = [float(t) for t in open(coords_name).read().split()]
        px = py = pz = 0.0
        j = 0
        while True:  # while(stream) checks BEFORE the reads
            if j < len(vals):
                px = vals[j]
            if j + 1 < len(vals):
                py = vals[j + 1]
            if j + 2 < len(vals):
                pz = vals[j + 2]
            cx = int(px / w[0])
            cy = int(py / w[1])
            cz = int(pz / w[2])
            if (0 <= cx < x.shape[2] and 0 <= cy < x.shape[1]
                    and 0 <= cz < x.shape[0]):
                x[cz, cy, cx] = 1.0
            if j + 3 > len(vals):  # a read failed: stream went bad
                break
            j += 3

    voxel_vol = float(w[0] * w[1] * w[2])
    if vol_total < 0:
        if mask is not None:
            vol_total = float(mask.sum()) * voxel_vol
        else:
            vol_total = x.size * voxel_vol
    if num_particles < 0:
        if mask is not None:
            num_particles = float((x * mask).sum())
        else:
            num_particles = float(x.sum())

    if truncate_ratio <= 0:
        truncate_ratio = float(np.sqrt(-2 * np.log(truncate_threshold)))

    out_img = None
    xd = to_device(x, device)
    maskd = None if mask is None else to_device(mask, device)
    for sigma_phys in sigmas:
        sigma = sigma_phys / w[0]
        hw = int(floor(sigma * truncate_ratio))
        k1 = K.gauss_kernel_1d(sigma, max(hw, 1))
        peak = float(k1[len(k1) // 2]) ** 3
        v_bin = (1.0 / peak) * voxel_vol

        blurred = div_rounded(apply_gauss(
            xd, sigma, mask=maskd, truncate_halfwidth=(max(hw, 1),) * 3
        ), voxel_vol)
        out_img = blurred

        # the extreme over the unmasked voxels, on the device: masked
        # voxels become +inf (-inf for the maximum), never preferred to a
        # finite value as numpy's nanargmin/nanargmax skip their NaN; ties
        # go to the first index in both
        sel = blurred
        if maskd is not None:
            if not bool((maskd != 0).any()):
                raise ValueError("All-NaN slice encountered")
            sel = torch.where(maskd != 0, blurred,
                              float("inf") if use_min else float("-inf"))
        flat = int(sel.argmin() if use_min else sel.argmax())
        extreme = float(sel.reshape(-1)[flat])
        del sel
        iz, iy, ix = np.unravel_index(flat, tuple(blurred.shape))

        ave_density = num_particles / vol_total
        k = extreme * v_bin
        lam = ave_density * v_bin
        num_bins = vol_total / v_bin
        if use_min:
            cdf = poisson_cdf_below(k, lam)
        else:
            below = sum(
                exp(i2 * np.log(lam) - lam - lgamma(i2 + 1.0))
                for i2 in range(int(floor(k))))
            cdf = 1.0 - below
        prob_total = 1.0 - (1.0 - cdf) ** num_bins
        # matches the reference exactly, including its extra factor of
        # voxel_width on top of the already-physical bin volume
        # (pval_mrc.cpp:479-480)
        eff_bin = v_bin ** (1.0 / 3) * w[0]
        print(f"{prob_total:.6g} {extreme:.6g} {ix} {iy} {iz} "
              f"{eff_bin:.6g}")

    if out_name and len(sigmas) == 1 and out_img is not None:
        mrc.write_mrc(out_name, to_host(out_img),
                      header=img.header if img is not None else None)
    return 0


def main():
    """Command-line entry: the blur runs on the CUDA card."""
    return run(sys.argv[1:], device="cuda")


if __name__ == "__main__":
    sys.exit(main())
