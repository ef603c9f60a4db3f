#!/usr/bin/env python3
"""Smoke test of the PyTorch port (visfd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA
   versions; refuses to run without CUDA;
1. builds the four CUDA kernels from ``visfd_tpu_torch/csrc`` (nvcc);
2. holds each kernel against its plain PyTorch twin on the card at the
   main path's shape, (Z, Y, X) = (256, 512, 512), and times both with
   CUDA events; then (2b) every kernel option on small volumes whose
   sides differ and are not multiples of a tile;
3. drives ``filter_mrc -membrane … -tv …`` (the port's CLI) on a seeded
   512 x 512 x 256 (X x Y x Z) phantom tomogram, checks that every
   kernel was launched, that the output is finite, and that the
   top-scoring voxels lie on the phantom's membranes; it records each
   kernel call of the run and holds its result against the twin on the
   same inputs; then a smaller input that takes the auto-binning path;
4. runs the CLI on an 112 x 96 x 80 phantom on the card and on the CPU
   (dense voting, ``-tv-best 1.0``) and compares the two outputs.

A failed check is reported where it happens and the later phases still
run; the script then exits non-zero without a result line.  On success
the second-to-last line is a JSON summary of the kernels and the last
line ``{"ok": true, "device": {...}}``.  TF32 is turned off for cuDNN
and matmuls (the twins use neither; this keeps it so).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
MAIN_SHAPE = (256, 512, 512)  # (Z, Y, X) of the main-path run

# what each kernel replaces: (name, CUDA source, TPU kernel body)
KERNELS = {
    "blur3": ("visfd_tpu_torch/csrc/blur.cu",
              "visfd_tpu/ops/blur_pallas.py:51"),
    "hessian_principal": ("visfd_tpu_torch/csrc/eigen.cu",
                          "visfd_tpu/ops/eigen_pallas.py:225"),
    "tv_votes": ("visfd_tpu_torch/csrc/tv.cu",
                 "visfd_tpu/ops/tv_pallas.py:80"),
    "sym3_score": ("visfd_tpu_torch/csrc/eigen.cu",
                   "visfd_tpu/ops/eigen_pallas.py:418"),
}


class Checks:
    """Collects pass/fail of every check; a failure does not stop the
    later phases, it only decides the exit code."""

    def __init__(self):
        self.failed = []

    def check(self, ok: bool, what: str) -> bool:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failed.append(what)
        return ok

    def run(self, phase, *args):
        """Run a phase; an exception fails it (traceback printed) and
        returns None, so the later phases still report."""
        try:
            return phase(*args)
        except Exception:  # reported, and decides the exit code
            traceback.print_exc()
            self.check(False, f"{phase.__name__} raised")
            return None


def close(got, want, rtol, atol_rel, absolute=False):
    """(ok, max |got - want|, atol) for float tensors on any device:
    |got - want| <= atol + rtol |want| everywhere, atol = atol_rel times
    the largest |want| (or atol_rel itself when ``absolute``).  Prints
    where it does not hold."""
    got, want = got.double(), want.double()
    atol = atol_rel if absolute else atol_rel * float(want.abs().max())
    diff = (got - want).abs()
    out = diff > atol + rtol * want.abs()
    if bool(out.any()):
        worst = int(((diff - atol) / want.abs().clamp(min=1e-30)).argmax())
        print(f"    {int(out.sum())} of {out.numel()} values out; max|want| "
              f"{float(want.abs().max()):.4g}; worst got "
              f"{float(got.reshape(-1)[worst]):.8g} want "
              f"{float(want.reshape(-1)[worst]):.8g}")
    return not bool(out.any()), float(diff.max()), atol


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, each timed with CUDA events."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------

def phase_card():
    import torch
    print("== phase 0: card", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build(chk):
    from visfd_tpu_torch import _cuda_build as cb
    print("== phase 1: build", flush=True)
    t0 = time.perf_counter()
    so = cb.build()
    cb.library()
    print(f"built {os.path.relpath(so, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    log = so.with_suffix(".log")
    if log.exists():
        for ln in log.read_text().splitlines():
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln:
                print("  ptxas:", ln.split("info    :")[-1].strip())
    chk.check(True, "kernels built and loaded")
    return so


def _eigen_check(chk, label, s_k, v_k, raw, formula):
    """A kernel's (score, v) against its twin's raw block (3 eigenvalues
    [+ 3 vector channels]) run on the host copy of the same input: the
    score to the eigen tolerances, the vector up to sign where the
    principal eigenvalue is separated.  Returns max |d| of the score."""
    import torch
    from visfd_tpu_torch.ops import eigen_cuda as EC
    vals = raw[:3]
    want = torch.stack(EC._score_channels(vals.movedim(0, -1), formula))
    tol = (1e-5, 1e-6) if formula == "planar" else (1e-4, 1e-5)
    ok, err, _ = close(s_k.cpu().reshape(want.shape), want, *tol)
    msg = f"{label} max|d|={err:.3g}"
    if v_k is not None:
        well = (vals[0] - vals[1]).abs() > 1e-3 * vals.abs().max()
        dot = (v_k.cpu() * raw[3:]).sum(0).abs()
        ok = ok and bool(dot[well].min() > 1 - 1e-4)
        msg += (f", min|v.v'|={float(dot[well].min()):.7f} on "
                f"{float(well.float().mean()):.4f} of voxels")
    chk.check(ok, msg)
    return err


def _tv_check(chk, label, got, got_den, raw):
    """Kernel votes (channel-major) against the twin's raw block: rtol
    2e-4, atol 2e-5 (or 2e-5 of the largest vote, if that is below 1)."""
    atol = 2e-5 * min(1.0, float(raw.abs().max()))
    ok, err, _ = close(got, raw[:6], 2e-4, atol, absolute=True)
    if got_den is not None:
        ok_d, err_d, _ = close(got_den, raw[6], 2e-4, atol, absolute=True)
        ok, err = ok and ok_d, max(err, err_d)
    chk.check(ok, f"{label} max|d|={err:.3g}")
    return err


def _sparse_equals_dense(chk, label, sp, sp_den, got, got_den):
    d = (sp - got).abs()
    ok = bool((d <= 3e-7 * got.abs()).all())
    if sp_den is not None:
        ok = ok and bool(((sp_den - got_den).abs()
                          <= 3e-7 * got_den.abs()).all())
    chk.check(ok, f"{label}: sparse == dense to rtol 3e-7 "
                  f"(max|d|={float(d.max()):.3g}, "
                  f"{int((d != 0).sum())} voxels differ at all)")


def phase_kernels(chk, card, shape=MAIN_SHAPE, dev="cuda"):
    """Each kernel against its twin at the main path's (Z, Y, X) shape;
    returns per-kernel stats."""
    import torch
    from visfd_tpu_torch.ops import blur_cuda, conv, eigen_cuda as EC
    from visfd_tpu_torch.ops import kernels as K
    from visfd_tpu_torch.ops.tv_cuda import tv_votes

    print(f"== phase 2: kernels against their plain twins, (Z, Y, X) = "
          f"{shape} [{card}]", flush=True)
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stats = {}

    def record(name, err, ms=None, plain_ms=None):
        s = stats.setdefault(name, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if ms is not None:
            s["ms"], s["plain_ms"] = ms, plain_ms

    # --- blur: unmasked and masked, hw 4 and 5 -------------------------
    x = torch.randn(shape, generator=gen, device=dev)
    m = (torch.rand(shape, generator=gen, device=dev) > 0.2).float()
    for hw, sigma in ((4, 1.73), (5, 2.0)):
        ks = [torch.as_tensor(K.gauss_kernel_1d(sigma, hw), device=dev)
              for _ in range(3)]
        ks[0] = ks[0] * torch.linspace(0.5, 1.5, 2 * hw + 1, device=dev)
        got = blur_cuda.blur3(x, ks)
        want = blur_cuda.blur3_plain(x, ks)
        ok, err, _ = close(got, want, 1e-5, 1e-6)
        chk.check(ok, f"blur3 hw={hw} (asymmetric x taps) max|d|={err:.3g}")
        got_m = conv.separable_conv3d(x, ks, mask=m)
        num = blur_cuda.blur3_plain(x * m, ks)
        den = blur_cuda.blur3_plain(m, ks)
        want_m = torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                             num)
        ok_m, err_m, _ = close(got_m, want_m, 1e-5, 1e-6)
        chk.check(ok_m, f"masked blur hw={hw} max|d|={err_m:.3g}")
        record("blur3", max(err, err_m))
        if hw == 4:
            ms = cuda_ms(lambda: blur_cuda.blur3(x, ks), 20)
            pms = cuda_ms(lambda: blur_cuda.blur3_plain(x, ks), 5)
            record("blur3", err, ms, pms)
            print(f"  blur3 hw=4: kernel {ms:.3f} ms, plain {pms:.3f} ms "
                  f"[{card}]")

    # --- Hessian + eigensolve: every formula, with the vector ----------
    # The eigen twins run on the CPU copy of the same input: torch's CUDA
    # sqrt is not correctly rounded (and its atan2/cos/sin differ from
    # the host's by an ulp), and the closed-form roots turn one ulp into
    # ~sqrt(eps) near a double eigenvalue.  The kernel uses IEEE sqrt and
    # the twin's order of operations, so it follows the host twin.
    blur = blur_cuda.blur3(x, [torch.as_tensor(K.gauss_kernel_1d(1.73, 4),
                                               device=dev)] * 3)
    blur_h = blur.cpu()
    for decreasing in (True, False):
        raw = EC.hessian_principal_plain(blur_h, 1.73, decreasing, "vals",
                                         True)
        for formula in ("planar", "linear", "stick", "vals"):
            s_k, v_k = EC.hessian_principal(blur, 1.73, decreasing,
                                            formula, True)
            record("hessian_principal", _eigen_check(
                chk, f"hessian_principal {formula} decreasing={decreasing}",
                s_k, v_k, raw, formula))
        del raw
    ms = cuda_ms(lambda: EC.hessian_principal(blur, 1.73, True, "planar",
                                              True), 20)
    pms = cuda_ms(lambda: EC.hessian_principal_plain(blur, 1.73, True,
                                                     "planar", True), 3)
    record("hessian_principal", 0.0, ms, pms)
    print(f"  hessian_principal planar+v: kernel {ms:.3f} ms, plain "
          f"{pms:.3f} ms (on the card) [{card}]")

    # --- TV: hw=3, exponent 4 -------------------------------------------
    hw = 3
    sigma = hw / np.sqrt(2.0) + 1e-6
    ratio = float(np.sqrt(2.0))
    zz, yy, xx = torch.meshgrid(*[torch.arange(n, device=dev,
                                               dtype=torch.float32)
                                  for n in shape], indexing="ij")
    u = torch.sin(zz * 12.9898 + yy * 78.233 + xx * 37.719).abs()
    sal_planes = torch.where(zz.long() % 20 == 0, u, 0.0)  # ~5% occupied
    sal_dense = torch.where(u > 0.4, u, 0.0)
    nv = torch.randn((3,) + tuple(shape), generator=gen, device=dev)
    nv = nv / nv.norm(dim=0, keepdim=True)
    del zz, yy, xx, u
    kw = dict(exponent=4, truncate_ratio=ratio, channel_major=True,
              nvec_channel_major=True)
    cases = [("dense", sal_dense, dict()),
             ("masked+denominator", sal_dense,
              dict(mask_src=m, want_denominator=True)),
             ("curves", sal_dense, dict(detect_curves=True)),
             ("planes 5%", sal_planes, dict())]
    for label, sal, extra in cases:
        got, got_den = tv_votes(sal, nv, sigma, **kw, **extra)
        raw = _tv_twin(sal, nv, sigma, ratio, **extra)
        record("tv_votes", _tv_check(chk, f"tv_votes hw=3 e=4 {label}",
                                     got, got_den, raw))
        del raw
        sp, sp_den = tv_votes(sal, nv, sigma, sparse=True, **kw, **extra)
        _sparse_equals_dense(chk, f"tv_votes {label}", sp, sp_den, got,
                             got_den)
        del got, got_den, sp, sp_den
    occ = float((sal_planes != 0).float().mean())
    ms = cuda_ms(lambda: tv_votes(sal_planes, nv, sigma, **kw), 5)
    ms_sp = cuda_ms(lambda: tv_votes(sal_planes, nv, sigma, sparse=True,
                                     **kw), 5)
    pms = cuda_ms(lambda: _tv_twin(sal_planes, nv, sigma, ratio), 2)
    record("tv_votes", 0.0, ms, pms)
    print(f"  tv_votes hw=3 e=4 planes field ({occ:.4f} occupied): dense "
          f"kernel {ms:.3f} ms, sparse kernel {ms_sp:.3f} ms, plain "
          f"{pms:.3f} ms [{card}]")

    # --- sym3 score of the vote tensor: stick, with v -------------------
    # (the twin on the CPU copy, as for the Hessian kernel)
    vote, _ = tv_votes(sal_dense, nv, sigma, **kw)
    s_k, v_k = EC.sym3_score(vote, True, "stick", True)
    raw = EC.sym3_score_plain(vote.cpu(), True, "vals", True)
    record("sym3_score", _eigen_check(chk, "sym3_score stick+v", s_k, v_k,
                                      raw, "stick"))
    ms = cuda_ms(lambda: EC.sym3_score(vote, True, "stick", False), 20)
    pms = cuda_ms(lambda: EC.sym3_score_plain(vote, True, "stick", False),
                  3)
    record("sym3_score", 0.0, ms, pms)
    print(f"  sym3_score stick: kernel {ms:.3f} ms, plain {pms:.3f} ms "
          f"(on the card) [{card}]", flush=True)
    return stats


def phase_small_shapes(chk, card, dev="cuda"):
    """Every kernel option against the twins on small volumes whose
    sides are neither equal nor multiples of a tile: asymmetric blur
    taps of a different length on each axis, every eigen formula and
    order, voting with hw 1-3, exponents 2-4, both nvec layouts, a mask
    with the denominator, curves, and sparse against dense."""
    import torch
    from visfd_tpu_torch.ops import conv, eigen_cuda as EC
    from visfd_tpu_torch.ops.tv_cuda import _tv_votes_plain, tv_votes

    print(f"== phase 2b: every option on small odd shapes [{card}]",
          flush=True)
    rng = np.random.default_rng(SEED)
    ks = [rng.uniform(0.05, 1.0, size=n).astype(np.float32)
          for n in (5, 3, 7)]
    errs = {}

    def record(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    for shape in ((21, 38, 67), (3, 7, 45)):
        x = rng.normal(size=shape).astype(np.float32)
        m = (rng.uniform(size=shape) > 0.25).astype(np.float32)
        xc, mc = torch.tensor(x, device=dev), torch.tensor(m, device=dev)
        for label, mask in (("", None), (" masked", mc)):
            got = conv.separable_conv3d(xc, ks, mask=mask)
            want = conv.separable_conv3d(
                torch.tensor(x), ks,
                mask=None if mask is None else torch.tensor(m))
            ok, err, _ = close(got.cpu(), want, 1e-5, 1e-6)
            chk.check(ok, f"{shape} blur taps 5/3/7{label} max|d|={err:.3g}")
            record("blur3", err)
        for decreasing in (True, False):
            raw = EC.hessian_principal_plain(torch.tensor(x), 1.7,
                                             decreasing, "vals", True)
            t6 = rng.normal(size=(6,) + shape).astype(np.float32)
            raw6 = EC.sym3_score_plain(torch.tensor(t6), decreasing,
                                       "vals", True)
            for formula in ("planar", "linear", "stick", "vals"):
                s_k, v_k = EC.hessian_principal(xc, 1.7, decreasing,
                                                formula, True)
                record("hessian_principal", _eigen_check(
                    chk, f"{shape} hessian_principal {formula} "
                         f"decreasing={decreasing}", s_k, v_k, raw, formula))
                s_k, v_k = EC.sym3_score(torch.tensor(t6, device=dev),
                                         decreasing, formula, True)
                record("sym3_score", _eigen_check(
                    chk, f"{shape} sym3_score {formula} "
                         f"decreasing={decreasing}", s_k, v_k, raw6,
                    formula))
        sal = rng.uniform(size=shape).astype(np.float32)
        sal[sal > 0.3] = 0.0
        sal[:, ::4] = 0.0
        nv = rng.normal(size=(3,) + shape).astype(np.float32)
        nv /= np.linalg.norm(nv, axis=0, keepdims=True)
        salc, nvc = torch.tensor(sal, device=dev), torch.tensor(nv, device=dev)
        nvc_last = nvc.movedim(0, -1).contiguous()
        for hw, e, curves, masked, cm in ((1, 2, False, False, False),
                                          (2, 3, False, False, True),
                                          (3, 4, False, False, False),
                                          (2, 4, False, True, True),
                                          (2, 4, True, False, True)):
            sigma = hw / np.sqrt(2.0) + 1e-6
            label = (f"{shape} tv_votes hw={hw} e={e}"
                     f"{' curves' if curves else ''}"
                     f"{' masked+denominator' if masked else ''}"
                     f" nvec {'(3,Z,Y,X)' if cm else '(Z,Y,X,3)'}")
            kw = dict(exponent=e, detect_curves=curves,
                      truncate_ratio=float(np.sqrt(2.0)),
                      mask_src=mc if masked else None,
                      want_denominator=masked, channel_major=True,
                      nvec_channel_major=cm)
            nv_in = nvc if cm else nvc_last
            got, got_den = tv_votes(salc, nv_in, sigma, **kw)
            raw = _tv_votes_plain(salc, nvc, mc if masked else None, sigma,
                                  e, curves, float(np.sqrt(2.0)), masked)
            record("tv_votes", _tv_check(chk, label, got, got_den, raw))
            sp, sp_den = tv_votes(salc, nv_in, sigma, sparse=True, **kw)
            _sparse_equals_dense(chk, label, sp, sp_den, got, got_den)
    return errs


def _tv_twin(sal, nv, sigma, ratio, mask_src=None, want_denominator=False,
             detect_curves=False):
    """The TV kernel's plain twin (``ops.tv_cuda._tv_votes_plain``) run
    on the card's tensors: the wrapper would send CUDA tensors to the
    kernel."""
    from visfd_tpu_torch.ops.tv_cuda import _tv_votes_plain
    return _tv_votes_plain(sal, nv, mask_src, sigma, 4, detect_curves,
                           ratio, want_denominator)


def _membrane_metrics(out, dist, near):
    """Share of the top 0.5% output voxels within ``near`` voxels of a
    phantom mid-surface."""
    import torch
    flat = out.reshape(-1)
    k = max(1, int(flat.numel() * 0.005))
    top = torch.topk(flat, k).indices
    return float((dist.reshape(-1)[top] <= near).float().mean())


class _Capture:
    """Records every call the CLI makes to the four kernel wrappers
    (arguments and results), by standing in for them in the modules
    that call them.  The wrappers still count their own launches (their
    own modules' names are left alone)."""

    def __init__(self):
        from visfd_tpu_torch.cli import filter_mrc as TFM
        from visfd_tpu_torch.ops import conv
        self.slots = [(conv, "blur3"), (TFM, "hessian_principal"),
                      (TFM, "tv_votes"), (TFM, "sym3_score")]
        self.calls = []

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name in self.slots]
        for (mod, name), fn in zip(self.slots, self.saved):
            setattr(mod, name, self._recorder(name, fn))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.slots, self.saved):
            setattr(mod, name, fn)

    def _recorder(self, name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls.append((name, fn, args, kwargs, out))
            return out
        return wrapped


def _check_captured(chk, calls):
    """Each kernel call of the main path against its twin on the same
    inputs: blur and voting twins on the card, eigen twins on the host
    copy (see phase 2).  The main path's sparse voting is also held
    against a dense launch on the same inputs.  Returns max |d| per
    kernel."""
    import inspect
    import torch
    from visfd_tpu_torch.ops import blur_cuda, eigen_cuda as EC
    from visfd_tpu_torch.ops.tv_cuda import _split_nvec, _tv_votes_plain

    errs = {}
    for name, fn, args, kwargs, out in calls:
        a = inspect.signature(fn).bind(*args, **kwargs)
        a.apply_defaults()
        a = a.arguments
        if name == "blur3":
            ks = [torch.as_tensor(k, dtype=torch.float32, device=out.device)
                  for k in a["kernels_xyz"]]
            ok, err, _ = close(out, blur_cuda.blur3_plain(a["x"], ks),
                               1e-5, 1e-6)
            chk.check(ok, f"main path blur3 {tuple(out.shape)} taps "
                          f"{[k.numel() for k in ks]} max|d|={err:.3g}")
        elif name == "hessian_principal":
            raw = EC.hessian_principal_plain(
                a["blur"].cpu(), a["sigma"], a["decreasing"], "vals",
                a["want_v"])
            err = _eigen_check(chk, f"main path hessian_principal "
                                    f"{a['formula']} {tuple(a['blur'].shape)}",
                               out[0], out[1], raw, a["formula"])
        elif name == "tv_votes":
            sal = a["saliency"]
            nv = _split_nvec(a["nvec"], sal.shape, a["nvec_channel_major"])
            raw = _tv_votes_plain(sal, nv, a["mask_src"], a["sigma"],
                                  a["exponent"], a["detect_curves"],
                                  a["truncate_ratio"], a["want_denominator"])
            vote = out[0] if a["channel_major"] else out[0].movedim(-1, 0)
            err = _tv_check(chk, f"main path tv_votes sparse={a['sparse']} "
                                 f"{tuple(sal.shape)}", vote, out[1], raw)
            del raw
            dense = fn(**{**a, "sparse": False})
            _sparse_equals_dense(chk, "main path tv_votes", out[0], out[1],
                                 dense[0], dense[1])
        else:
            raw = EC.sym3_score_plain(a["t6"].cpu(), a["decreasing"], "vals",
                                      a["want_v"])
            err = _eigen_check(chk, f"main path sym3_score {a['formula']} "
                                    f"{tuple(a['t6'].shape)}",
                               out[0], out[1], raw, a["formula"])
        errs[name] = max(errs.get(name, 0.0), err)
    return errs


def phase_main_path(chk, card, tmp, shapes=(MAIN_SHAPE, (128, 256, 256)),
                    dev="cuda"):
    import torch
    from visfd_tpu_torch.cli import filter_mrc as TFM
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.ops import blur_cuda, eigen_cuda as EC
    from visfd_tpu_torch.ops import tv_cuda
    from visfd_tpu_torch.utils.phantom import membrane_phantom
    from visfd_tpu_torch.utils.progress import Report

    wrappers = {"blur3": blur_cuda.blur3,
                "hessian_principal": EC.hessian_principal,
                "tv_votes": tv_cuda.tv_votes,
                "sym3_score": EC.sym3_score}
    launches, errs = {}, {}
    runs = [
        # (label, shape zyx, thickness, argv tail, near)
        ("", shapes[0], 3.0,
         "-w 1 -membrane minima 3 -tv 1.5 -tv-angle-exponent 4", 3.0),
        (" auto-binned", shapes[1], 6.0,
         "-w 1 -membrane minima 6 -tv 1.5 -tv-angle-exponent 4", 4.0),
    ]
    for i, (label, shape, thick, args, near) in enumerate(runs):
        print(f"== phase 3: main path, {'x'.join(map(str, shape[::-1]))} "
              f"(X x Y x Z){label} [{card}]", flush=True)
        vol, dist = membrane_phantom(shape, seed=SEED + i, thickness=thick,
                                     device=dev)
        fin, fout = os.path.join(tmp, f"in{i}.mrc"), \
            os.path.join(tmp, f"out{i}.mrc")
        mrc.write_mrc(fin, vol.cpu().numpy())
        del vol
        for w in wrappers.values():
            w.launches = 0
        rep = Report(None)
        with _Capture() as cap:
            t0 = time.perf_counter()
            rc = TFM.run(["-in", fin, "-out", fout] + args.split(),
                         device=dev, report=rep)
            wall = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        if i == 0:
            launches = counts
        chk.check(rc == 0, f"filter_mrc {args} exit {rc}")
        print(f"  wall {wall:.3f} s for read + filter + write; stages: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in rep.timings.items())
              + f"; {rep.format_paths()} [{card}]")
        chk.check(all(c > 0 for c in counts.values()),
                  f"launch counts in the run: {counts}")
        out = mrc.read_mrc(fout).data
        chk.check(out.shape == shape and bool(np.isfinite(out).all()),
                  f"output {out.shape} finite={bool(np.isfinite(out).all())}"
                  f" (input {shape})")
        share = _membrane_metrics(torch.tensor(out, device=dev),
                                  dist, near)
        chk.check(share >= 0.9, f"top 0.5% voxels within {near} voxels of "
                                f"a phantom membrane: {share:.4f}")
        for k, e in _check_captured(chk, cap.calls).items():
            errs[k] = max(errs.get(k, 0.0), e)
        del dist, cap
        os.unlink(fin)
        os.unlink(fout)
    return launches, errs


def phase_card_vs_cpu(chk, card, tmp, shape=(80, 96, 112), dev="cuda"):
    import torch
    from visfd_tpu_torch.cli import filter_mrc as TFM
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.utils.phantom import membrane_phantom
    from visfd_tpu_torch.utils.progress import Report

    print(f"== phase 4: card against CPU, (Z, Y, X) = {shape}, dense "
          f"voting [{card}]", flush=True)
    vol, _ = membrane_phantom(shape, seed=SEED + 7, thickness=3.0)
    fin = os.path.join(tmp, "small.mrc")
    mrc.write_mrc(fin, vol.numpy())
    args = "-w 1 -membrane minima 3 -tv 1.5 -tv-best 1.0".split()
    outs = {}
    for d in (dev, "cpu"):
        fout = os.path.join(tmp, f"small_{d}.mrc")
        t0 = time.perf_counter()
        TFM.run(["-in", fin, "-out", fout] + args, device=d,
                report=Report(None))
        print(f"  {d}: {time.perf_counter() - t0:.3f} s")
        outs[d] = torch.tensor(mrc.read_mrc(fout).data)
    ok, err, atol = close(outs[dev], outs["cpu"], 2e-4, 2e-5)
    d = (outs[dev].double() - outs["cpu"].double()).abs()
    bad = int((d > atol + 2e-4 * outs["cpu"].double().abs()).sum())
    chk.check(ok, f"card == CPU to rtol 2e-4, atol 2e-5 x max: "
                  f"max|d|={err:.3g} (atol {atol:.3g}), {bad} voxels out")


def main() -> int:
    try:
        import torch  # noqa: F401
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    card = phase_card()
    if card is None:
        return 2
    sys.path.insert(0, ROOT)
    try:
        import visfd_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    chk = Checks()
    t_start = time.perf_counter()
    if chk.run(phase_build, chk) is None:
        return 1  # nothing else can run without the kernels
    stats = chk.run(phase_kernels, chk, card)
    small = chk.run(phase_small_shapes, chk, card)
    with tempfile.TemporaryDirectory(prefix=".tmp_chip_smoke_", dir=ROOT) as tmp:
        main_path = chk.run(phase_main_path, chk, card, tmp)
        chk.run(phase_card_vs_cpu, chk, card, tmp)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if chk.failed:
        print(f"chip_smoke: {len(chk.failed)} check(s) failed:",
              file=sys.stderr)
        for f in chk.failed:
            print(f"  {f}", file=sys.stderr)
        return 1
    launches, main_errs = main_path
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        s = stats[name]
        err = max(s["max_abs_err"], small[name], main_errs[name])
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": s["ms"],
                        "plain_ms": s["plain_ms"]})
    import torch
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
