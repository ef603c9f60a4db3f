#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels on one NVIDIA GPU.

    python3 tune_kernels.py [--reps N] [--kernels main|filters]

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
bit against the first's.  One JSON line per variant and turn; the last
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


def build(name, edits, cb, tmp):
    """Copy csrc, apply the edits and start one nvcc per source; returns
    (directory, [(source, process)])."""
    d = os.path.join(tmp, name.replace(" ", "_"))
    shutil.copytree(cb.CSRC, d)
    for fn, old, new in edits:
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
    for src, p in procs:
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc {src} failed\n{out}")
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", choices=("main", "filters"), default="main")
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
    if args.kernels == "filters":
        ok = tune_filters(cb, args.reps)
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
