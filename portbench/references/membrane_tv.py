"""The plain reference of ``membrane_tv``: what ``filter_mrc -membrane
minima T -tv F -tv-angle-exponent 4 -bin B`` writes, recomputed in
float64 from the input tomogram (``handlers.cpp:1501-2357``).

1. bin: the mean of each B^3 block;
2. blur: the reference's discrete Gaussian at sigma = T / sqrt(3)
   (voxels of the binned grid), halfwidth floor(sigma * ratio), zero
   padded, divided by the blur of an all-ones volume;
3. Hessian: central differences times sigma^2, each face voxel taking
   the Hessian of the nearest voxel one inside;
4. eigen: the three eigenvalues by the trigonometric formula, the
   principal (largest) one's eigenvector by the largest cross product
   of the rows of A - lambda I; planar score (l1^2 - l2^2)^2;
5. -tv-best: the score at 0-based position floor(n f) of the
   descending order; scores below it become 0;
6. stick voting at sigma F T / sqrt(3), halfwidth floor(sigma * tv
   ratio): every kept source s sends to s + j, for each tap j of the
   corner-truncated Gaussian table, sal w (1 - (n.rhat)^2)^2 nr nr^T,
   nr = 2 (n.rhat) rhat - n (``feature.hpp:2141-2203``), sources taken
   tap by tap so that no two votes of one call meet;
7. the stick score l1 - l2 of the vote tensor.

``low=True`` is the control: each stage's output rounded to bfloat16.
Imports nothing of the program."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from portbench.harness import mrcfile, plain


def _rounder(low: bool):
    if not low:
        return lambda t: t
    return lambda t: t.to(torch.bfloat16).to(torch.float64)


def gen_gauss_table(sigma: float, hw: int) -> np.ndarray:
    """exp(-(r / sigma)^2) on the (2hw+1)^3 cube, zero below its value
    at the end of an axis, normalised (``filter3d.hpp:546-638``);
    float64, (Z, Y, X)."""
    trunc = math.exp(-((hw / sigma) ** 2.0))
    z, y, x = np.meshgrid(*[np.arange(-hw, hw + 1, dtype=np.float64)] * 3,
                          indexing="ij")
    r = np.sqrt((x / sigma) ** 2 + (y / sigma) ** 2 + (z / sigma) ** 2)
    h = np.exp(-(r ** 2.0))
    h = np.where(np.abs(h) < trunc, 0.0, h)
    return h / h.sum()


def hessian(blur: torch.Tensor) -> torch.Tensor:
    """(6, Z, Y, X) [xx, yy, zz, xy, yz, xz] by central differences,
    faces replicated from one voxel inside."""
    p = torch.nn.functional.pad(blur, (1,) * 6)
    nz, ny, nx = blur.shape

    def at(dz, dy, dx):
        return p[1 + dz:1 + dz + nz, 1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]
    c2 = 2 * at(0, 0, 0)
    h = torch.stack([
        at(0, 0, 1) + at(0, 0, -1) - c2,
        at(0, 1, 0) + at(0, -1, 0) - c2,
        at(1, 0, 0) + at(-1, 0, 0) - c2,
        0.25 * (at(0, 1, 1) + at(0, -1, -1) - at(0, -1, 1) - at(0, 1, -1)),
        0.25 * (at(1, 1, 0) + at(-1, -1, 0) - at(-1, 1, 0) - at(1, -1, 0)),
        0.25 * (at(1, 0, 1) + at(-1, 0, -1) - at(1, 0, -1) - at(-1, 0, 1))])
    for axis, n in ((1, nz), (2, ny), (3, nx)):
        idx = torch.arange(n, device=blur.device).clamp(1, n - 2)
        h = h.index_select(axis, idx)
    return h


def eigenvalues(t: torch.Tensor):
    """(largest, middle, smallest) eigenvalues of the symmetric
    matrices of a (6, ...) field [xx, yy, zz, xy, yz, xz]."""
    a, b, c, d, e, f = t
    q = (a + b + c) / 3
    p1 = d * d + e * e + f * f
    p2 = (a - q) ** 2 + (b - q) ** 2 + (c - q) ** 2 + 2 * p1
    p = torch.sqrt(p2 / 6)
    ap, bp, cp = a - q, b - q, c - q
    det = ap * (bp * cp - e * e) - d * (d * cp - e * f) + f * (d * e - bp * f)
    safe = torch.where(p > 0, p, torch.ones_like(p))
    r = torch.clamp(det / (2 * safe ** 3), -1.0, 1.0)
    phi = torch.acos(r) / 3
    l0 = q + 2 * p * torch.cos(phi)
    l2 = q + 2 * p * torch.cos(phi + 2 * math.pi / 3)
    return l0, 3 * q - l0 - l2, l2


def principal_vector(t: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """(3, ...) unit eigenvector (x, y, z) of eigenvalue ``lam``: the
    longest cross product of two rows of A - lam I."""
    a, b, c, d, e, f = t
    r0 = torch.stack([a - lam, d, f])
    r1 = torch.stack([d, b - lam, e])
    r2 = torch.stack([f, e, c - lam])
    cands = [torch.linalg.cross(u, v, dim=0)
             for u, v in ((r0, r1), (r0, r2), (r1, r2))]
    norms = torch.stack([(v * v).sum(0) for v in cands])
    best = norms.argmax(0)
    v = torch.where(best == 0, cands[0], torch.where(best == 1, cands[1],
                                                      cands[2]))
    n = torch.sqrt(norms.max(0).values)
    return v / torch.where(n > 0, n, torch.ones_like(n))


def vote(sal: torch.Tensor, vec: torch.Tensor, sigma: float, hw: int,
         exponent: int) -> torch.Tensor:
    """(6, Z, Y, X) stick votes of the non-zero sources of ``sal``."""
    shape = sal.shape
    dev = sal.device
    src = torch.nonzero(sal.reshape(-1)).reshape(-1)
    zyx = torch.stack(torch.unravel_index(src, shape))
    s = sal.reshape(-1)[src]
    n = vec.reshape(3, -1)[:, src]
    acc = torch.zeros((6, sal.numel()), dtype=torch.float64, device=dev)
    table = gen_gauss_table(sigma, hw)
    lim = torch.tensor(shape, device=dev)[:, None]
    for jz, jy, jx in zip(*np.nonzero(table)):
        w = float(table[jz, jy, jx])
        j = (int(jz) - hw, int(jy) - hw, int(jx) - hw)
        length = math.sqrt(sum(v * v for v in j)) or 1.0
        rh = torch.tensor([j[2] / length, j[1] / length, j[0] / length],
                          dtype=torch.float64, device=dev)
        r = zyx + torch.tensor(j, device=dev)[:, None]
        ok = ((r >= 0) & (r < lim)).all(0)
        rr = r[:, ok]
        nn = n[:, ok]
        sin = (nn * rh[:, None]).sum(0)
        amp = s[ok] * w * (1 - sin * sin) ** (exponent // 2)
        nr = 2 * sin * rh[:, None] - nn
        contrib = torch.stack([nr[0] * nr[0], nr[1] * nr[1], nr[2] * nr[2],
                               nr[0] * nr[1], nr[1] * nr[2], nr[0] * nr[2]])
        flat = (rr[0] * shape[1] + rr[1]) * shape[2] + rr[2]
        acc.index_add_(1, flat, contrib * amp)
    return acc.reshape((6,) + tuple(shape))


def expected(vol: torch.Tensor, config: Dict, low: bool = False
             ) -> torch.Tensor:
    """The output tomogram (float32, binned) for the input ``vol``."""
    p = config["parameters"]
    rnd = _rounder(low)
    b = int(p["bin"])
    nz, ny, nx = (n // b for n in vol.shape)
    x = vol[:nz * b, :ny * b, :nx * b].to(torch.float64)
    x = rnd(x.reshape(nz, b, ny, b, nx, b).mean((1, 3, 5)))
    w = p["voxel_width_A"] * b
    sigma = p["thickness_A"] / math.sqrt(3.0) / w
    hw = max(1, int(math.floor(sigma * plain.truncate_ratio(
        p["filter_truncate_threshold"]))))
    k = plain.gauss_kernel_1d(sigma, hw)
    blur = rnd(plain.blur3(x, k) / plain.edge_denominator(
        k, x.shape, torch.float64, x.device))
    del x
    h = hessian(blur) * (sigma * sigma)
    del blur
    l0, l1, _ = eigenvalues(h)
    vec = rnd(principal_vector(h, l0))
    del h
    score = rnd((l0 * l0 - l1 * l1) ** 2)
    del l0, l1
    n = score.numel()
    kth = min(int(math.floor(n * p["tv_best"])), n - 1)
    thr = torch.sort(score.reshape(-1), descending=True).values[kth]
    sal = torch.where(score < thr, 0.0, score)
    del score
    tv_sigma = p["tv_sigma_per_blur_sigma"] * sigma
    tv_hw = int(math.floor(tv_sigma * p["tv_truncate_ratio"]))
    votes = rnd(vote(sal, vec, tv_sigma, tv_hw, int(p["tv_exponent"])))
    del sal, vec
    v0, v1, _ = eigenvalues(votes)
    return (v0 - v1).to(torch.float32)


def compare(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """rel_l2: |got - want| / |want| over the whole tomogram (float64)."""
    g, w = got.to(torch.float64), want.to(torch.float64)
    return {"rel_l2": float(torch.linalg.vector_norm(g - w)
                            / torch.linalg.vector_norm(w))}


def _input(inputs: Dict[str, str], device) -> torch.Tensor:
    _, data = mrcfile.read(inputs["input"])
    return torch.from_numpy(data).to(device)


def header_fields_wrong(h: mrcfile.Header, data: np.ndarray,
                        config: Dict, in_zyx) -> int:
    """How many of the output's header fields disagree with its data and
    the binned grid: the sizes, the mode, the cell (sizes times the
    binned voxel width), dmin, dmax and dmean."""
    p = config["parameters"]
    w = p["voxel_width_A"] * p["bin"]
    nz, ny, nx = (n // p["bin"] for n in in_zyx)
    cell = tuple(float(np.float32(n * w)) for n in (nx, ny, nz))
    top = max(abs(float(data.min())), abs(float(data.max())), 1e-30)
    return sum([
        h.nxyz != (nx, ny, nz) or data.shape != (nz, ny, nx),
        h.mode != mrcfile.MODE_FLOAT,
        h.cell != cell,
        h.dmin != float(data.min()),
        h.dmax != float(data.max()),
        abs(h.dmean - float(data.mean(dtype=np.float64))) > 1e-6 * top])


def check(outputs: Dict[str, str], inputs: Dict[str, str], config: Dict,
          device) -> Tuple[Dict[str, float], Dict]:
    """The numbers compared for the program's output file."""
    h, got = mrcfile.read(outputs["output"])
    vol = _input(inputs, device)
    wrong = header_fields_wrong(h, got, config, vol.shape)
    want = expected(vol, config)
    nums = compare(torch.from_numpy(got).to(device), want)
    nums["header_fields_wrong"] = wrong
    return nums, {"voxels": int(got.size)}


def control(inputs: Dict[str, str], config: Dict, device) -> Dict[str, float]:
    """The numbers of the bfloat16 reference in the program's place."""
    vol = _input(inputs, device)
    nums = compare(expected(vol, config, low=True), expected(vol, config))
    nums["header_fields_wrong"] = 0
    return nums
