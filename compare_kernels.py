#!/usr/bin/env python3
"""Time the voting, blur and eigen kernels of this checkout, and
optionally of another checkout, on one NVIDIA GPU, on the same inputs.

    python3 compare_kernels.py [--other DIR] [--reps N]
                               [--kernels all|main|filters]

The inputs are built once, with code both checkouts share unchanged
(the phantom, the plain blur twin, the Hessian kernel, the sort
threshold), so every checkout sees the same bits:

- ``real``: the ``-tv-best 0.05`` field of the phantom's planar score at
  the main path's (Z, Y, X) = (256, 512, 512), the field the CLI's
  sparse voting gets;
- ``planes``: the 5%-occupied field of every 20th z plane;
- ``dense``: a 74%-occupied random field;
- ``block``: the ``-tv-best 0.05`` field of a (262, 518, 1030) phantom,
  one (256, 512, 1024) block of the -mesh run with its 3-deep halos;
- ``blur``, ``blur_pad``, ``blur_big``: the blurred phantom (sigma 1.73,
  hw 4, the plain twin) at the main path's shape, at (258, 514, 1026)
  (one block of the -mesh run with its 1-deep halos) and at the -mesh
  run's (512, 1024, 1024);
- ``vote``, ``vote_big``: the raw votes of ``real`` and of the
  ``-tv-best 0.05`` field of ``blur_big``'s phantom, the inputs of the
  vote score at 67M and 537M voxels; ``vote_dense``, those of
  ``dense`` (every voxel's tensor non-zero).

Each checkout's ``visfd_tpu_torch`` is imported in turn (the other, this,
this, the other).  ``--kernels filters`` (or ``all``) times the dense
correlation (``conv3d_dense``) at ``-ggauss 2``'s 7^3 and ``-dogg 2 4``'s
15^3 kernels on (256, 512, 512), ``-doggxy 2 4 2``'s (1, 21, 21) on
(512, 1024, 1024) and ``-template-gauss 3 6``'s 31^3 on (16, 512, 512);
the other compiled widths, ``-fluct 2|3 -exponent 3``'s 3^3 and 5^3, on
(256, 512, 512); two widths only the runtime instance takes,
``-ggauss 3``'s 11^3 on (256, 512, 512) and ``-dogg 3 6``'s 23^3 on
(16, 512, 512); and the blur's per-axis mode (``blur3_axis``) at hw 55
on (256, 512, 512) and hw 60 and 80 on (64, 512, 512), seeded ``randn``
inputs, and counts the output words of this checkout that differ in
any bit from the other's first turn.  ``--kernels main`` (or ``all``)
times ``blur3`` at hw 4, ``tv_votes`` (hw 3, exponent 4) dense and
sparse on every field, and ``tv_votes_prepadded`` sparse on the block,
``hessian_principal``
(planar + v) at 67M and 537M voxels, ``hessian_principal_prepadded`` on
the haloed block (and ``hessian_principal_block`` on the same block and
halos, where the checkout has it), and ``sym3_score`` (stick) on the
three vote fields, with CUDA events (median of ``--reps``).  It prints
one JSON line per turn, then the fields' occupancy.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from chip_smoke import cuda_ms, occupancy

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
MAIN_SHAPE = (256, 512, 512)
BLOCK = (256, 512, 1024)
BIG = (512, 1024, 1024)
HW = 3
SIGMA_H = 1.73


def load(root):
    """Import the ``visfd_tpu_torch`` package of checkout ``root``,
    dropping any other checkout's modules first."""
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "visfd_tpu_torch"]:
        del sys.modules[name]
    sys.path[:] = [root] + [p for p in sys.path if p not in (ROOT, root)]
    import visfd_tpu_torch  # noqa: F401
    return visfd_tpu_torch


def blurred_phantom(shape, seed, dev, sigma=SIGMA_H):
    """A seeded phantom blurred by the plain blur twin (hw 4)."""
    import torch
    from visfd_tpu_torch.ops import blur_cuda
    from visfd_tpu_torch.ops import kernels as K
    from visfd_tpu_torch.utils.phantom import membrane_phantom
    vol, _ = membrane_phantom(shape, seed=seed, thickness=3.0, device=dev)
    ks = [torch.as_tensor(K.gauss_kernel_1d(sigma, 4), device=dev)] * 3
    return blur_cuda.blur3_plain(vol, ks)


def tv_best_field(shape, seed, dev, blur=None):
    """(saliency, direction (3, Z, Y, X)) as the CLI's ``-membrane
    minima 3 -tv-best 0.05`` leaves them, from the plain blur twin (or
    from ``blur``, that phantom already blurred)."""
    import torch
    from visfd_tpu_torch.ops import eigen_cuda as EC
    from visfd_tpu_torch.parallel.reduce import fraction_threshold
    sigma = 3.0 / np.sqrt(3.0)
    if blur is None:
        blur = blurred_phantom(shape, seed, dev, sigma)
    score, v = EC.hessian_principal(blur, sigma)
    del blur
    thr = fraction_threshold(score, 0.05)
    return torch.where(score < thr, 0.0, score), v


def build_inputs(dev):
    import torch
    zz, yy, xx = torch.meshgrid(*[torch.arange(n, device=dev,
                                               dtype=torch.float32)
                                  for n in MAIN_SHAPE], indexing="ij")
    u = torch.sin(zz * 12.9898 + yy * 78.233 + xx * 37.719).abs()
    planes = torch.where(zz.long() % 20 == 0, u, 0.0)
    dense = torch.where(u > 0.4, u, 0.0)
    del zz, yy, xx, u
    gen = torch.Generator(device=dev).manual_seed(SEED)
    nv = torch.randn((3,) + MAIN_SHAPE, generator=gen, device=dev)
    nv = nv / nv.norm(dim=0, keepdim=True)
    x = torch.randn(MAIN_SHAPE, generator=gen, device=dev)
    real, real_v = tv_best_field(MAIN_SHAPE, SEED, dev)
    pshape = tuple(n + 2 * HW for n in BLOCK)
    block, block_v = tv_best_field(pshape, SEED + 50, dev)
    inp = dict(x=x, nv=nv, planes=planes, dense=dense, real=real,
               real_v=real_v, block=block, block_v=block_v)
    inp["vote"] = votes(real, real_v)
    inp["vote_dense"] = votes(dense, nv)
    inp["blur"] = blurred_phantom(MAIN_SHAPE, SEED + 1, dev)
    inp["blur_pad"] = blurred_phantom(tuple(n + 2 for n in BLOCK),
                                      SEED + 2, dev)
    sigma = 3.0 / np.sqrt(3.0)
    inp["blur_big"] = blurred_phantom(BIG, SEED + 3, dev, sigma)
    sal, v = tv_best_field(BIG, SEED + 3, dev, blur=inp["blur_big"])
    inp["vote_big"] = votes(sal, v)
    return inp


def votes(sal, v):
    """The raw (6, Z, Y, X) votes of a field (sparse, hw 3, exponent 4)."""
    from visfd_tpu_torch.ops.tv_cuda import tv_votes
    return tv_votes(sal, v, HW / np.sqrt(2.0) + 1e-6, exponent=4,
                    truncate_ratio=float(np.sqrt(2.0)), sparse=True,
                    channel_major=True, nvec_channel_major=True)[0]


def block_halos(bp):
    """The contiguous block inside a 1-haloed (Z+2, Y+2, X+2) block and
    its halo slabs (z below and above with their corner rows, y below
    and above), as the sharded Hessian hands them over."""
    return [t.contiguous() for t in (bp[1:-1, 1:-1, 1:-1], bp[0, :, 1:-1],
                                     bp[-1, :, 1:-1], bp[1:-1, 0, 1:-1],
                                     bp[1:-1, -1, 1:-1])]


def time_checkout(inp, reps):
    import torch
    from visfd_tpu_torch.ops import blur_cuda
    from visfd_tpu_torch.ops import kernels as K
    from visfd_tpu_torch.ops.tv_cuda import tv_votes, tv_votes_prepadded
    dev = inp["x"].device
    out = {}
    ks = [torch.as_tensor(K.gauss_kernel_1d(1.73, 4), device=dev)
          for _ in range(3)]
    ks[0] = ks[0] * torch.linspace(0.5, 1.5, 9, device=dev)
    out["blur3 hw 4"] = cuda_ms(lambda: blur_cuda.blur3(inp["x"], ks),
                                4 * reps)
    sigma = HW / np.sqrt(2.0) + 1e-6
    kw = dict(exponent=4, truncate_ratio=float(np.sqrt(2.0)),
              channel_major=True, nvec_channel_major=True)
    for name, sal, nv in (("real", inp["real"], inp["real_v"]),
                          ("planes", inp["planes"], inp["nv"]),
                          ("dense", inp["dense"], inp["nv"])):
        for sparse in (True, False):
            out[f"tv_votes {name} {'sparse' if sparse else 'dense'}"] = \
                cuda_ms(lambda: tv_votes(sal, nv, sigma, sparse=sparse,
                                         **kw), reps)
    out["tv_votes_prepadded block sparse"] = cuda_ms(
        lambda: tv_votes_prepadded(inp["block"], inp["block_v"], sigma,
                                   BLOCK, sparse=True, **kw), reps)
    from visfd_tpu_torch.ops import eigen_cuda as EC
    out["hessian_principal planar+v"] = cuda_ms(
        lambda: EC.hessian_principal(inp["blur"], SIGMA_H), 4 * reps)
    out["hessian_principal planar+v 537M"] = cuda_ms(
        lambda: EC.hessian_principal(inp["blur_big"], SIGMA_H), reps)
    out["hessian_principal_prepadded block planar+v"] = cuda_ms(
        lambda: EC.hessian_principal_prepadded(inp["blur_pad"], SIGMA_H),
        2 * reps)
    if hasattr(EC, "hessian_principal_block"):
        parts = block_halos(inp["blur_pad"])
        out["hessian_principal_block block planar+v"] = cuda_ms(
            lambda: EC.hessian_principal_block(*parts, SIGMA_H), 2 * reps)
        del parts
    out["sym3_score stick"] = cuda_ms(lambda: EC.sym3_score(inp["vote"]),
                                      4 * reps)
    out["sym3_score stick 537M"] = cuda_ms(
        lambda: EC.sym3_score(inp["vote_big"]), reps)
    out["sym3_score stick dense-field votes"] = cuda_ms(
        lambda: EC.sym3_score(inp["vote_dense"]), 4 * reps)
    return out


def filter_inputs(dev):
    """Seeded inputs and kernels of the dense and per-axis modes, as
    chip_smoke.py's phases 8a and 9a build them."""
    import torch
    from chip_smoke import _exp_kernels, _gauss_taps
    from visfd_tpu_torch.ops import kernels as K
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    k31, _, k2 = _exp_kernels()
    dense = {
        "7^3": (MAIN_SHAPE, K.gen_gauss_kernel_3d((2.0,) * 3, 2.0, (3,) * 3)),
        "15^3": (MAIN_SHAPE, K.dogg_kernel_3d((2.0,) * 3, (4.0,) * 3, 2.0,
                                              2.0, -1.0, 0.03)[0]),
        "(1, 21, 21)": (BIG, k2),
        "31^3": ((16, 512, 512), k31),
        "3^3": (MAIN_SHAPE, K.gen_gauss_kernel_3d((2.0,) * 3, 2.0, (1,) * 3)),
        "5^3": (MAIN_SHAPE, K.gen_gauss_kernel_3d((2.0,) * 3, 2.0, (2,) * 3)),
        "11^3 (runtime)": (MAIN_SHAPE, K.gen_gauss_kernel_3d((3.0,) * 3, 2.0,
                                                            (5,) * 3)),
        "23^3 (runtime)": ((16, 512, 512), K.dogg_kernel_3d(
            (3.0,) * 3, (6.0,) * 3, 2.0, 2.0, -1.0, 0.03)[0])}
    inp = {"x": {}, "dense": {}, "axis": {}}
    for shape in (MAIN_SHAPE, BIG, (16, 512, 512), (64, 512, 512)):
        inp["x"][shape] = torch.randn(shape, generator=gen, device=dev)
    for name, (shape, k) in dense.items():
        inp["dense"][name] = (shape, torch.as_tensor(
            k, dtype=torch.float32, device=dev).flip(0, 1, 2).contiguous())
    for hw, shape in ((55, MAIN_SHAPE), (60, (64, 512, 512)),
                      (80, (64, 512, 512))):
        ks = _gauss_taps(hw, dev)
        ks[0] = ks[0] * torch.linspace(0.5, 1.5, 2 * hw + 1, device=dev)
        inp["axis"][f"hw {hw}"] = (shape, ks)
    return inp


def time_filters(inp, reps):
    """(times, outputs) of the dense kernel and the per-axis blur mode."""
    from visfd_tpu_torch.ops import blur_cuda, dense_cuda
    out, res = {}, {}
    for name, (shape, kf) in inp["dense"].items():
        x = inp["x"][shape]
        res[f"conv3d_dense {name}"] = dense_cuda.conv3d_dense(x, kf)
        out[f"conv3d_dense {name}"] = cuda_ms(
            lambda: dense_cuda.conv3d_dense(x, kf), reps)
    for name, (shape, ks) in inp["axis"].items():
        x = inp["x"][shape]
        res[f"blur3_axis {name}"] = blur_cuda.blur3_axis(x, ks)
        out[f"blur3_axis {name}"] = cuda_ms(
            lambda: blur_cuda.blur3_axis(x, ks), 2 * reps)
    return out, res


def bits_differ(a, b) -> int:
    """Output words of a and b that differ in any bit."""
    import torch
    return int(torch.count_nonzero(a.view(torch.int32)
                                   != b.view(torch.int32)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of another checkout to time in "
                                    "turns with this one")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", choices=("all", "main", "filters"),
                    default="all")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(f"card: {card}", flush=True)
    other = os.path.abspath(args.other) if args.other else None
    load(ROOT)
    dev = torch.device("cuda")
    main_k = args.kernels in ("all", "main")
    filt_k = args.kernels in ("all", "filters")
    inp = build_inputs(dev) if main_k else None
    finp = filter_inputs(dev) if filt_k else None
    occ = {k: occupancy(inp[k], HW) for k in ("real", "planes", "dense",
                                              "block")} if main_k else {}
    turns = [other, ROOT, ROOT, other] if other else [ROOT, ROOT]
    first = None  # the first turn's outputs of the filter kernels
    for root in turns:
        load(root)
        from visfd_tpu_torch import _cuda_build as cb
        cb.library()
        t = time_checkout(inp, args.reps) if main_k else {}
        differ = {}
        if filt_k:
            ft, res = time_filters(finp, args.reps)
            t.update(ft)
            if first is None:
                first = res
            else:
                differ = {k: bits_differ(v, first[k])
                          for k, v in res.items()}
            del res
        label = "this" if root == ROOT else "other"
        print(json.dumps({"checkout": label, "root": root, "ms": t,
                          "words_differing_from_first_turn": differ}),
              flush=True)
    for k, v in occ.items():
        print(f"occupancy {k}: {json.dumps(v)}")
    print(f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
