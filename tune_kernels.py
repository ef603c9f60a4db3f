#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels on one NVIDIA GPU.

    python3 tune_kernels.py [--reps N] [--kernels main|filters|ladder]

Each entry of VARIANTS edits a copy of ``visfd_tpu_torch/csrc`` (exact
text replacements), which is built with the package's nvcc flags into a
library of its own.  The variants are timed in turns, first to last and
then last to first, on the inputs of ``compare_kernels.py``: ``blur3``
at hw 4, ``tv_votes`` (hw 3, exponent 4) dense and sparse on the
``-tv-best 0.05`` field and the 74% field, ``hessian_principal``
(planar + v) at the main path's shape, ``hessian_principal_block`` on
one block of the -mesh run beside its halo slabs and ``sym3_score``
(stick) on the votes of the ``-tv-best 0.05`` field.  Every variant's
outputs must equal the first variant's bit for bit (an edit may change
the schedule, not the arithmetic), and sparse voting must equal
dense.  ``--kernels filters`` takes FILTER_VARIANTS instead and times
the dense correlation and the blur's per-axis mode on
``compare_kernels.filter_inputs``, each variant's outputs checked bit for
bit against the first's; ``--kernels ladder`` takes LADDER_VARIANTS and
times the blur's wide instance at the blob ladder's halfwidths on 268M
voxels, checked bit for bit against the first variant's and the runtime
instance's outputs.  One JSON line per variant and turn; the last
line says whether every check held.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

import compare_kernels as CK
from chip_smoke import cuda_ms

ROOT = os.path.dirname(os.path.abspath(__file__))

# name -> [(source file, text, replacement)]
VARIANTS = {
    "as is": [],
    "tv kTZ 2": [("tv.cu", "constexpr int kTZ = 4;", "constexpr int kTZ = 2;")],
    "tv kTZ 8": [("tv.cu", "constexpr int kTZ = 4;", "constexpr int kTZ = 8;")],
    "tv kTZ 16": [("tv.cu", "constexpr int kTZ = 4;",
                   "constexpr int kTZ = 16;")],
    "blur kR 1": [("blur.cu", "constexpr int kR = 4;", "constexpr int kR = 1;")],
    "blur kR 2": [("blur.cu", "constexpr int kR = 4;", "constexpr int kR = 2;")],
    "eigen kZT 2": [("eigen.cu", "constexpr int kZT = 4;",
                     "constexpr int kZT = 2;")],
    "eigen kZT 8": [("eigen.cu", "constexpr int kZT = 4;",
                     "constexpr int kZT = 8;")],
    "eigen kZC 64": [("eigen.cu", "constexpr int kZC = 32;",
                      "constexpr int kZC = 64;")],
    "eigen 4 blocks an SM": [("eigen.cu", "__launch_bounds__(kThreads, 2)",
                              "__launch_bounds__(kThreads, 4)")],
    "eigen 5 blocks an SM": [("eigen.cu", "__launch_bounds__(kThreads, 2)",
                              "__launch_bounds__(kThreads, 5)")],
}

FILTER_VARIANTS = {
    "as is": [],
    # every kernel shape through the runtime instance, with the plan the
    # compiled one gets (the same shared bytes, stages and band)
    "dense runtime instance": [("conv3d.cu", "  switch (variant) {",
                                "  switch (0) {")],
    "axis rotations unrolled 2": [
        ("blur.cu", "    for (; u + 8 * (kAxG + 1) <= nc;",
         "#pragma unroll 2\n    for (; u + 8 * (kAxG + 1) <= nc;")],
}


# text edits of csrc/blur.cu's wide instance, timed at the blob ladder's
# halfwidths on 268M voxels (``--kernels ladder``); "py" entries set the
# module constants of ops/blur_cuda that mirror an edited tile
LADDER_VARIANTS = {
    "as is": [],
    "1 block an SM": [("blur.cu", "__launch_bounds__(kWWarps * 32, 2)",
                       "__launch_bounds__(kWWarps * 32, 1)")],
    "x pass 4 outputs a thread": [("blur.cu", "constexpr int kWXR = 8;",
                                   "constexpr int kWXR = 4;")],
    "3 staged planes": [("blur.cu", "constexpr int kWStages = 4;",
                         "constexpr int kWStages = 3;"),
                        ("py", "_WIDE_STAGES", 3)],
    "streaming stores": [("blur.cu", "          out[zo * nplane + "
                          "static_cast<int64_t>(yb + q) * nx + x] = o[q];",
                          "          __stcs(&out[zo * nplane + "
                          "static_cast<int64_t>(yb + q) * nx + x], o[q]);")],
}
LADDER_SHAPE = (256, 1024, 1024)


def build(name, edits, cb, tmp):
    """Copy csrc, apply the edits and start one nvcc per source; returns
    (directory, [(source, process)])."""
    d = os.path.join(tmp, name.replace(" ", "_"))
    shutil.copytree(cb.CSRC, d)
    for fn, old, new in edits:
        if fn == "py":
            continue
        path = os.path.join(d, fn)
        text = open(path).read()
        if old not in text:
            raise ValueError(f"{name}: {old!r} not in {fn}")
        open(path, "w").write(text.replace(old, new))
    srcs = sorted(f for f in os.listdir(d) if f.endswith(".cu"))
    return d, [(s, subprocess.Popen(
        [cb._nvcc(), *cb.NVCC_FLAGS, "-c", "-o", s + ".o", s], cwd=d,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for s in srcs]


def link(name, d, procs, cb):
    """Wait for the compiles of a variant and link its library."""
    logs = []
    for src, p in procs:
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc {src} failed\n{out}")
        logs.append(out)
    with open(os.path.join(d, "ptxas.log"), "w") as fh:
        fh.write("".join(logs))
    subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS[:2], "-shared", "-o",
                    "lib.so", *[s + ".o" for s, _ in procs]], cwd=d,
                   check=True, capture_output=True)
    return os.path.join(d, "lib.so")


def load(path, cb):
    lib = ctypes.CDLL(path)
    for name, argtypes in cb._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.visfd_error_string.argtypes = [ctypes.c_int]
    lib.visfd_error_string.restype = ctypes.c_char_p
    return lib


def tune_filters(cb, reps):
    """Time FILTER_VARIANTS in turns (first to last, last to first) on
    the dense and per-axis inputs; True when every variant's outputs
    equal the first's bit for bit."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        builds = {n: build(n, e, cb, tmp)
                  for n, e in FILTER_VARIANTS.items()}
        libs = {n: load(link(n, *b, cb), cb) for n, b in builds.items()}
        inp = CK.filter_inputs(torch.device("cuda"))
        names = list(FILTER_VARIANTS)
        ref, ok = None, True
        for order in (names, names[::-1]):
            for name in order:
                cb.library = (lambda lib: lambda: lib)(libs[name])
                t, res = CK.time_filters(inp, reps)
                ref = res if ref is None else ref
                differ = {k: CK.bits_differ(v, ref[k])
                          for k, v in res.items()}
                ok = ok and not any(differ.values())
                del res
                print(json.dumps({"variant": name, "ms": t,
                                  "words differing from the first "
                                  "variant": differ}), flush=True)
    return ok


def tune_ladder(cb, reps):
    """Time LADDER_VARIANTS in turns (first to last, last to first) at
    the blob ladder's halfwidths on LADDER_SHAPE, each through the wide
    instance; True when every variant's outputs equal the first's, and
    the first's the runtime instance's, bit for bit."""
    import torch
    from chip_smoke import _gauss_taps, _ptxas_report, bound_ms
    from visfd_tpu_torch.ops import blur_cuda
    with tempfile.TemporaryDirectory() as tmp:
        builds = {n: build(n, e, cb, tmp)
                  for n, e in LADDER_VARIANTS.items()}
        libs = {n: load(link(n, *b, cb), cb) for n, b in builds.items()}
        for n, (d, _) in builds.items():
            with open(os.path.join(d, "ptxas.log")) as fh:
                for ln in _ptxas_report(fh.read()):
                    if ln.startswith("blur3_kernel_wide"):
                        print(f"{n}: {ln}", flush=True)
        gen = torch.Generator(device="cuda").manual_seed(CK.SEED + 19)
        x = torch.randn(LADDER_SHAPE, generator=gen, device="cuda")
        nvox = x.numel()
        names = list(LADDER_VARIANTS)
        ref, ok = {}, True
        consts = {k: getattr(blur_cuda, k) for e in LADDER_VARIANTS.values()
                  for fn, k, _ in e if fn == "py"}
        for order in (names, names[::-1]):
            for name in order:
                cb.library = (lambda lib: lambda: lib)(libs[name])
                for k, v in consts.items():
                    setattr(blur_cuda, k, v)
                for fn, k, v in LADDER_VARIANTS[name]:
                    if fn == "py":
                        setattr(blur_cuda, k, v)
                t, differ = {}, {}
                for h in blur_cuda.WIDE_HALFWIDTHS:
                    ks = _gauss_taps(h, "cuda")
                    out = blur_cuda.blur3_fused(x, ks, "wide")
                    if h not in ref:
                        ref[h] = out
                        rt = blur_cuda.blur3_fused(x, ks, "runtime")
                        ok = ok and CK.bits_differ(out, rt) == 0
                        del rt
                    differ[h] = CK.bits_differ(out, ref[h])
                    del out
                    ms = cuda_ms(lambda: blur_cuda.blur3_fused(
                        x, ks, "wide"), reps)
                    b = bound_ms(8 * nvox, 6 * (2 * h + 1) * nvox)[0]
                    t[f"hw {h}"] = f"{ms:.3f} ms, {100 * b / ms:.1f}%"
                ok = ok and not any(differ.values())
                print(json.dumps({"variant": name, "ms": t,
                                  "words differing from the first "
                                  "variant": differ}), flush=True)
        for k, v in consts.items():
            setattr(blur_cuda, k, v)
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", choices=("main", "filters", "ladder"),
                    default="main")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tune_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    CK.load(ROOT)
    from visfd_tpu_torch import _cuda_build as cb
    from visfd_tpu_torch.ops import blur_cuda, eigen_cuda, tv_cuda
    from visfd_tpu_torch.ops import kernels as K
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(f"card: {card}", flush=True)
    if args.kernels in ("filters", "ladder"):
        ok = (tune_filters if args.kernels == "filters" else tune_ladder)(
            cb, args.reps)
        print(f"[{card}]")
        print(json.dumps({"ok": ok}))
        return 0 if ok else 1
    with tempfile.TemporaryDirectory() as tmp:
        builds = {n: build(n, e, cb, tmp) for n, e in VARIANTS.items()}
        libs = {n: load(link(n, *b, cb), cb) for n, b in builds.items()}
        dev = torch.device("cuda")
        inp = CK.build_inputs(dev)
        sigma = CK.HW / np.sqrt(2.0) + 1e-6
        kw = dict(exponent=4, truncate_ratio=float(np.sqrt(2.0)),
                  channel_major=True, nvec_channel_major=True)
        ks = [torch.as_tensor(K.gauss_kernel_1d(1.73, 4), device=dev)] * 3
        halos = CK.block_halos(inp["blur_pad"])
        names = list(VARIANTS)
        ref, ok = None, True
        for order in (names, names[::-1]):
            for name in order:
                cb.library = (lambda lib: lambda: lib)(libs[name])
                t = {"blur3 hw 4": cuda_ms(
                    lambda: blur_cuda.blur3(inp["x"], ks), 4 * args.reps)}
                for f, sal, nv in (("real", inp["real"], inp["real_v"]),
                                   ("dense", inp["dense"], inp["nv"])):
                    for sp in (True, False):
                        t[f"tv_votes {f} {'sparse' if sp else 'dense'}"] = \
                            cuda_ms(lambda: tv_cuda.tv_votes(
                                sal, nv, sigma, sparse=sp, **kw), args.reps)
                hess = (
                    lambda: eigen_cuda.hessian_principal(inp["blur"],
                                                         CK.SIGMA_H),
                    lambda: eigen_cuda.hessian_principal_block(
                        *halos, CK.SIGMA_H),
                    lambda: eigen_cuda.sym3_score(inp["vote"]))
                for label, fn in zip(("hessian_principal planar+v",
                                      "hessian_principal_block planar+v",
                                      "sym3_score stick"), hess):
                    t[label] = cuda_ms(fn, 4 * args.reps)
                outs = [tv_cuda.tv_votes(inp["real"], inp["real_v"], sigma,
                                         sparse=sp, **kw)[0]
                        for sp in (True, False)]
                outs.append(blur_cuda.blur3(inp["x"], ks))
                outs += [torch.cat([o.reshape(-1) for o in fn()
                                    if o is not None]) for fn in hess]
                ref = outs if ref is None else ref
                differ = [int((a.view(torch.int32) != b.view(torch.int32))
                              .sum()) for a, b in zip(outs + outs[:1],
                                                      ref + outs[1:2])]
                ok = ok and not any(differ)
                print(json.dumps({"variant": name, "ms": t,
                                  "bits differing from the first variant "
                                  "(sparse, dense, blur, hessian, block, "
                                  "vote score), sparse vs dense": differ}),
                      flush=True)
    print(f"[{card}]")
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
