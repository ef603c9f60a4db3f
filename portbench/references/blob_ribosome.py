"""The plain reference of ``blob_ribosome``: the minima list that
``filter_mrc -w W -mask M -blob minima B d0 d1 g`` writes, recomputed
from the input tomogram and mask (``BlobDogD``/``BlobDog``,
``feature.hpp:53-512``), and the comparison of a list with it.

The ladder: n = 1 + ceil(ln(d1 / d0) / ln g) diameters d0 g'^i, g' =
(d1 / d0)^(1 / n), in voxels, sigma = d / (2 sqrt 3).  Each scale's
LoG is the difference of the masked, normalised Gaussians at sigma (1
-+ delta / 2) (halfwidth floor(ratio sigma (1 + delta / 2)), ratio from
the truncation threshold), over delta^2, in float32 on the device.  A
voxel of scale k (1 .. n - 2) is a minimum when it lies in the mask,
its value is negative, and each of its 80 neighbours in (x, y, z,
scale) lies in the volume and the mask and is larger.

Comparison.  Blobs match on (voxel, scale).  A blob in one list only is
allowed where the reference's values lie within rounding of making it
a minimum or not: its flip distance, the least change of the reference
LoG that would flip it (the smaller of its gap to the nearest
neighbour and |value| for a reference minimum; the larger of the
deepest neighbour's excess and its value for one that is not), over
the deepest reference minimum's |value|.  ``tie_margin`` is the
largest flip distance of a blob in one list only (0 where the lists
agree; infinite where a neighbour is out of the volume or the mask);
``score_gap`` the largest |score difference| of a matched blob, over
the same scale.

``low=True`` is the control: the input and each LoG rounded to
bfloat16.  Imports nothing of the program."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.harness import mrcfile, plain

OFFSETS = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1)]


def ladder_diameters(p: Dict) -> List[float]:
    """The ladder's diameters in voxels (``settings.cpp``'s -blob)."""
    d0, d1, g = p["diameter_min_A"], p["diameter_max_A"], p["ladder_ratio"]
    n = 1 + int(np.ceil(np.log(d1 / d0) / np.log(g)))
    g = (d1 / d0) ** (1.0 / n)
    diam = [d0]
    for _ in range(1, n):
        diam.append(diam[-1] * g)
    return [d / p["voxel_width_A"] for d in diam]


def sigmas(p: Dict) -> List[float]:
    return [d / (2.0 * np.sqrt(3.0)) for d in ladder_diameters(p)]


def log_halfwidth(sigma: float, p: Dict) -> int:
    tr = plain.truncate_ratio(p["filter_truncate_threshold"])
    return max(1, int(np.floor(tr * sigma * (1.0 + 0.5 * p[
        "delta_sigma_over_sigma"]))))


def _blur3(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """The kernel along z, y and x, zero padded: each output the sum of
    the taps times the shifted inputs, accumulated in place."""
    n_taps = len(k)
    hw = n_taps // 2
    for axis in range(3):
        pad = [0, 0] * 3
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = hw
        xp = torch.nn.functional.pad(x, pad)
        n = x.shape[axis]
        x = xp.narrow(axis, 0, n) * float(k[-1])
        for t in range(1, n_taps):
            x.add_(xp.narrow(axis, t, n), alpha=float(k[n_taps - 1 - t]))
        del xp
    return x


def _masked_blur(xm, m, sigma, hw):
    k = np.float32(plain.gauss_kernel_1d(sigma, hw))
    num = _blur3(xm, k)
    den = _blur3(m, k)
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), num)


def log(xm: torch.Tensor, m: torch.Tensor, sigma: float, p: Dict):
    d = p["delta_sigma_over_sigma"]
    hw = log_halfwidth(sigma, p)
    ga = _masked_blur(xm, m, sigma * (1.0 - 0.5 * d), hw)
    gb = _masked_blur(xm, m, sigma * (1.0 + 0.5 * d), hw)
    return (ga - gb) * (1.0 / (d * d))


def _nan_padded(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    v = torch.where(m != 0, v, torch.nan)
    return torch.nn.functional.pad(v, (1,) * 6, value=torch.nan)


def _min3(v: torch.Tensor, axis: int) -> torch.Tensor:
    """The least of each voxel's three neighbours along ``axis`` (the
    result one shorter at each end there); NaN wins."""
    n = v.shape[axis] - 2
    return torch.minimum(torch.minimum(v.narrow(axis, 0, n),
                                       v.narrow(axis, 1, n)),
                         v.narrow(axis, 2, n))


def _minima(ring: List[torch.Tensor]):
    """(flat indices, values) of the minima of the middle scale of three
    NaN-padded volumes, raster order."""
    prev, mid, nxt = ring
    c = mid[1:-1, 1:-1, 1:-1]
    # the 3 x 3 rows of each plane, then the 27 of a box; the middle
    # scale's 26: the boxes of the planes above and below, its plane's
    # rows above and below, and its row's voxels left and right
    row_m = _min3(mid, 2)
    sq_m = _min3(row_m, 1)
    low = torch.minimum(sq_m[:-2], sq_m[2:])
    low = torch.minimum(low, torch.minimum(row_m[1:-1, :-2], row_m[1:-1, 2:]))
    low = torch.minimum(low, torch.minimum(mid[1:-1, 1:-1, :-2],
                                           mid[1:-1, 1:-1, 2:]))
    for vol in (prev, nxt):
        low = torch.minimum(low, _min3(_min3(_min3(vol, 2), 1), 0))
    hit = (low > c) & (c < 0)
    flat = torch.nonzero(hit.reshape(-1)).reshape(-1)
    return flat, c.reshape(-1)[flat]


def _flip_distance(ring, flat: torch.Tensor, is_ref_min: bool):
    """The flip distance (unnormalised) of the voxels ``flat`` of the
    middle scale."""
    prev, mid, nxt = ring
    nz, ny, nx = (n - 2 for n in mid.shape)
    z, y, x = (t + 1 for t in torch.unravel_index(flat, (nz, ny, nx)))
    c = mid[z, y, x].double()
    gaps = []
    for vol in ring:
        for dz, dy, dx in OFFSETS:
            if vol is mid and dz == dy == dx == 0:
                continue
            gaps.append(vol[z + dz, y + dy, x + dx].double() - c)
    g = torch.stack(gaps).min(0).values
    g = torch.nan_to_num(g, nan=-torch.inf)
    if is_ref_min:
        return torch.minimum(g, -c)
    d = torch.maximum(-g, c)
    return torch.where(torch.isnan(c), torch.inf, d)


class Blobs:
    """A minima list as voxels (flat index), scale indices and scores."""

    def __init__(self, flat, scale, score):
        self.flat = np.asarray(flat, np.int64)
        self.scale = np.asarray(scale, np.int64)
        self.score = np.asarray(score, np.float64)

    def __len__(self):
        return len(self.flat)


def read_list(path: str, config: Dict, shape) -> Blobs:
    """A list file ('x y z d score' in physical units) as ``Blobs``."""
    p = config["parameters"]
    w = p["voxel_width_A"]
    rows = np.loadtxt(path, ndmin=2) if open(path).read().strip() else \
        np.zeros((0, 5))
    diam = np.asarray(ladder_diameters(p))
    xyz = np.rint(rows[:, :3] / w).astype(np.int64)
    scale = np.abs(rows[:, 3:4] / w - diam[None]).argmin(1)
    nz, ny, nx = shape
    flat = (xyz[:, 2] * ny + xyz[:, 1]) * nx + xyz[:, 0]
    return Blobs(flat, scale, rows[:, 4])


def run_ladder(vol: torch.Tensor, mask: torch.Tensor, config: Dict,
               low: bool = False, visit=None) -> Blobs:
    """The reference's minima; ``visit(k, ring, flat, values)`` sees each
    middle scale k with its NaN-padded ring and its minima."""
    p = config["parameters"]
    sig = sigmas(p)
    rnd = ((lambda t: t.to(torch.bfloat16).to(torch.float32)) if low
           else (lambda t: t))
    m = mask.to(torch.float32)
    xm = rnd(vol.to(torch.float32)) * m
    ring: List[torch.Tensor] = []
    flats, scales, scores = [], [], []
    for k, s in enumerate(sig):
        ring.append(_nan_padded(rnd(log(xm, m, s, p)), m))
        if len(ring) > 3:
            ring.pop(0)
        if len(ring) < 3:
            continue
        flat, val = _minima(ring)
        if visit is not None:
            visit(k - 1, ring, flat, val)
        flats.append(flat.cpu().numpy())
        scales.append(np.full(len(flat), k - 1))
        scores.append(val.double().cpu().numpy())
    if not flats:
        return Blobs([], [], [])
    return Blobs(np.concatenate(flats), np.concatenate(scales),
                 np.concatenate(scores))


def compare(got: Blobs, vol: torch.Tensor, mask: torch.Tensor,
            config: Dict) -> Tuple[Dict[str, float], Dict[str, int]]:
    """(numbers, counts) of ``got`` against the reference."""
    flips: List[float] = []
    gaps: List[float] = []
    counts = {"reference": 0, "got": len(got), "matched": 0,
              "reference_only": 0, "got_only": 0}
    dev = vol.device

    def visit(k, ring, flat, val):
        sel = got.scale == k
        g_flat, g_score = got.flat[sel], got.score[sel]
        r_flat = flat.cpu().numpy()
        r_score = val.double().cpu().numpy()
        common, ig, ir = np.intersect1d(g_flat, r_flat, return_indices=True)
        counts["reference"] += len(r_flat)
        counts["matched"] += len(common)
        gaps.extend(np.abs(g_score[ig] - r_score[ir]).tolist())
        only_r = np.setdiff1d(r_flat, g_flat)
        only_g = np.setdiff1d(g_flat, r_flat)
        counts["reference_only"] += len(only_r)
        counts["got_only"] += len(only_g)
        for idx, is_ref in ((only_r, True), (only_g, False)):
            if len(idx):
                d = _flip_distance(ring, torch.as_tensor(idx, device=dev),
                                   is_ref)
                flips.extend(d.cpu().numpy().tolist())

    ref = run_ladder(vol, mask, config, visit=visit)
    outside = int(((got.scale < 1) | (got.scale > len(sigmas(
        config["parameters"])) - 2)).sum())
    counts["got_only"] += outside
    scale = float(np.abs(ref.score).max()) if len(ref) else 1.0
    tie = max(flips) / scale if flips else 0.0
    if outside:
        tie = math.inf
    return ({"tie_margin": tie,
             "score_gap": max(gaps) / scale if gaps else 0.0}, counts)


def _inputs(inputs: Dict[str, str], device):
    _, vol = mrcfile.read(inputs["input"])
    _, mask = mrcfile.read(inputs["mask"])
    return (torch.from_numpy(vol).to(device),
            torch.from_numpy(mask).to(device))


def check(outputs: Dict[str, str], inputs: Dict[str, str], config: Dict,
          device) -> Tuple[Dict[str, float], Dict]:
    """The numbers compared for the program's minima file."""
    vol, mask = _inputs(inputs, device)
    got = read_list(outputs["minima"], config, vol.shape)
    return compare(got, vol, mask, config)


def control(inputs: Dict[str, str], config: Dict, device) -> Dict[str, float]:
    """The numbers of the bfloat16 reference in the program's place."""
    vol, mask = _inputs(inputs, device)
    low = run_ladder(vol, mask, config, low=True)
    return compare(low, vol, mask, config)[0]
