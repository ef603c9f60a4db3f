#!/usr/bin/env python3
"""Smoke test of the PyTorch port (visfd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --nccl    # 2+ cards: the build and phase 11

Phase 11 (``--nccl``, ``phase_cards``): ``-mesh`` over NCCL with one
card a rank (two ranks, then one on every card), 5c's command at 537M
and 6c's ``-connect``, each against the one-process ``-mesh`` over the
same cards bit for bit, each rank's gather no faster than 900 GB/s on
its exchanges' clock; then 13c (``phase_checkpoint_cards``): every card's
rank saves 5c's run with ``-save-progress-sharded``, two ranks and one
process ``-mesh 4`` load it, and its arrays equal those one process
computes without it; its last line ``{"ok": ..., "cards": n}``.

Phases:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA
   versions; refuses to run without CUDA;
1. builds the CUDA kernels from ``visfd_tpu_torch/csrc`` (one nvcc per
   source, all at once) and prints ptxas's registers, spills and stack
   for every kernel instantiation, and the SASS instructions per voxel
   of each eigen kernel instantiation (``cuobjdump``, when the toolkit
   has it);
2. holds each kernel against its plain PyTorch twin on the card at the
   main path's shape, (Z, Y, X) = (256, 512, 512), and times both with
   CUDA events; the voting kernel on the field the main path votes on
   (the ``-tv-best 0.05`` share of a phantom's planar score, with its
   occupancy at three granularities), on a 5%-occupied "planes" field
   and on a 74%-occupied one; the vote score without and with its
   principal vector (the ``-connect`` path), with
   ``torch.linalg.eigvalsh`` / ``eigh`` timed on a 32nd of the
   planes; then (2b) every kernel option on small
   volumes whose sides differ and are not multiples of a tile, the
   per-shard Hessian entry on a strided view of a block with its halo
   slabs among them;
3. drives ``filter_mrc -membrane … -tv …`` (the port's CLI) on a seeded
   512 x 512 x 256 (X x Y x Z) phantom tomogram, checks that every
   kernel was launched, that the output is finite, and that the
   top-scoring voxels lie on the phantom's membranes; it records each
   kernel call of the run, prints the occupancy of the voting field it
   captured, and holds each result against the twin on the same
   inputs; then a smaller input that takes the auto-binning path;
4. runs the CLI on an 112 x 96 x 80 phantom on the card and on the CPU
   (dense voting, ``-tv-best 1.0``) and compares the two outputs;
5. the ``-mesh`` path on a (2, 2) mesh (all four blocks on ``cuda:0``
   when one card is visible, spread over the cards otherwise):
   (5a) the per-shard modes of the Hessian (a block read in place beside
   its four halo slabs) and voting kernels against their plain twins on
   one block of 5c's shape, timed beside the single-device kernels on as
   many voxels (the voting on the block's own ``-tv-best 0.05`` field),
   then the sharded wrappers on small volumes whose blocks are 1, 2 and
   3 voxels thick under halos deeper than a block; (5b) every sharded
   stage (blur, Hessian, the ``-tv-best`` threshold, sparse and dense
   voting, vote score with and without its vector) against its
   single-device counterpart at (Z, Y, X) = (256, 1024, 1024), counting
   the voxels whose bits differ (0 expected), with the Hessian stage's
   sharded/single ratio and the vote score's share of its bound, and the
   halo copies timed on their own; the vote score with its vector per
   block also against its twin on a block's first 16 planes, timed there
   with ``torch.linalg.eigh``;
   (5c) ``filter_mrc -membrane … -tv …
   -mesh 4`` and the same command without ``-mesh`` on a seeded 1024 x
   1024 x 256 phantom: identical outputs, each per-shard kernel launched
   once per block, both walls and the peak device memory;
6. ``-connect``: (6c) ``filter_mrc -membrane minima 3 -tv 1.5
   -tv-angle-exponent 4 -connect T -connect-angle 30`` on a seeded 512 x
   512 x 256 phantom (its 1024 x 1024 x 256 run is in 7d), T the 96th
   percentile of that phantom's stick score (printed): every kernel
   launched, the
   vote score with its vector, the stage spans (gates, seeds, candidate
   mask + compaction, candidate copy, native flood, finalize, write),
   the candidate, seed and cluster counts, peak card memory and the
   host's peak RSS, and the share of the 10 largest clusters' voxels
   within 2 voxels of a phantom mid-surface; (6a) on the smaller run's
   own score, vote and vector: the seeds and the candidate lists on the
   card against the same functions on the CPU (identical), the discard
   gates on a 64 x 256 x 256 crop, card against CPU, equal wherever a
   gate's two sides differ by more than 1e-5 of the larger and the
   saliency Hessian's principal eigenvector is well defined (the rest
   counted), and the native flood against its Python twin on a 64^3
   crop (identical); (6b) the C++ reference's goldens on the card, bit
   for bit: ``-load-progress tests/golden/ref_prog`` with ``-connect
   1e+09 -connect-angle 30 -normals-file -select-cluster 1``, ``-connect
   5e+09 -connect-angle 10`` and the same with ``-must-link``, on a
   zero 16^3 input, and ``-connect 37`` on ``ref_gauss.mrc``, and
   ``-edge … -tv`` on the card against the CPU; then
   ``-select-cluster 1 -normals-file`` on a 96 x 96 x 48 phantom, with
   the walker's seconds per PLY vertex;
7. the segmentation handlers and the intensity map: (7a) ``-find-minima``
   and ``-find-maxima`` at 1024 x 1024 x 256 (a membrane phantom blurred
   at sigma 3): walls, extrema counts, card against CPU on a crop; (7b)
   ``-watershed minima``, the native flood, at 64 x 512 x 512, its
   microseconds per voxel,
   the flood against its Python twin on a crop, ``ref_gauss.mrc`` with
   and without ``-markers`` card against CPU; (7c)
   ``-watershed-device`` at 1024 x 1024 x 256: wall, each loop's rounds,
   card memory and host RSS, crops against the CPU and against the host
   flood on distinct values; (7d) ``-mesh 4`` on one card against one
   device, bit for bit: ``-watershed-device`` (with and without
   boundaries), ``-edge`` and ``-select-cluster 1 -normals-file``, then
   ``-connect`` at 1024 x 1024 x 256 on one device and with ``-mesh 4``
   (spans, card memory, host RSS, launches); (7e) ``-thresh2``,
   ``-thresh4``, ``-clip``, ``-cl``, ``-thresh-gauss``, ``-rescale``,
   ``-fill``, ``-mask-rect``/``-mask-sphere`` and ``-image-size``, card
   against CPU;
8. the convolution filters and blob detection: (8a) the blur's per-axis
   mode (the halfwidths no fused tile holds) against its twin at
   halfwidths 60 and 80 on (64, 512, 512), timed beside cuDNN ``conv3d``
   per axis (TF32 off), and against the fused kernel where both run;
   the per-axis mode at 8e's ``-gauss 21`` (halfwidth 55) on
   (256, 512, 512) against its twin; the fused kernel at the blob
   ladder's halfwidths 6-11 at 1024 x 1024 x 256 (6-10 the wide
   instance, bit for bit the runtime instance it replaced and timed
   beside it); the dense-correlation
   kernel at -ggauss's and -dogg's kernels (7^3, 15^3) on (256, 512, 512)
   beside ``conv3d``; each per-axis and dense time as a share of its
   bound, beside the time of the design before (``BEFORE_MS``); (8g)
   the blob extremum kernel on three LoG scales of 8b's phantom at
   1024 x 1024 x 256, with its mask and without one: its codes and
   ``_scale_candidates``' lists equal to the twin's, exactly, its time
   beside the twin's and its bound; (8b)
   ``filter_mrc -w 19.6 -mask M -blob minima B 160 280 1.01`` (the
   reference's ladder, 58 scales)
   on a seeded 1024 x 1024 x 256 phantom of 1500 dark spheres: the
   ``blur3`` launches against the ladder's 4 a scale (all of them the
   wide instance's, the run's Report count too), the extremum
   kernel's one a mid scale, the spans (read,
   LoG ladder, extremum test, compaction, NMS, drawing, write), wall,
   peak card memory, host peak RSS, and the share of the phantom's
   centres found within 1 voxel; (8c) the blob lists of a 64 x 128 x 128
   crop, card against CPU, a blob in one list only allowed where its
   extremum margin is below 1e-4 (counted); (8d) ``-discard-blobs
   -blob-separation 1.1`` and ``-draw-spheres`` on 8b's list at full
   size; (8e) ``-gauss 21`` (halfwidth 55: the per-axis mode),
   ``-ggauss``, ``-dog``, ``-dogg``, ``-log``, ``-fluct``, ``-median 2``,
   ``-erode 2`` and ``-open 2`` at 512 x 512 x 256, each card against
   CPU on a crop; (8f) ``-blob … -mesh 4`` on one card against 8b, bit
   for bit, the extremum kernel once a slab of a block a mid scale;
9. the experimental handlers, the 2-D filters and the nine tools: (9a)
   the dense kernel's (1, 21, 21) mode (``-doggxy 2 4 2``'s 2-D pass) at
   1024 x 1024 x 512 and its 31^3 mode (``-template-gauss 3 6``'s
   amplitude) on (16, 512, 512) against their twins, timed beside cuDNN
   ``conv3d``; ``-template-gauss 3 6`` and ``-doggxy 2 4 2`` at ``-w 1``
   on 8b's input, with and without 8b's mask (launches, walls, spans,
   peak card memory), with ``-mesh 4`` bit for bit one device, and a
   (24, 48, 64) crop card against CPU; (9b) on a seeded 512 x 512 x 256
   phantom, ``-distance-points`` with 1000 points (8 planes bit for bit
   the CPU's, with and without ``-mask``), ``-distance-to-voxels``
   (distances equal the CPU's), ``-random-spheres`` (300 of diameter
   12), and ``-blob-radial-intensity min`` over 500 of 8b's blobs; (9c)
   the nine tools on 8b's and 9a's files (``combine_mrc``,
   ``sum_voxels``, ``pval_mrc`` on the point image of 8b's blobs,
   ``crop_mrc``, ``convert_to_float``, ``print_mrc_stats``,
   ``histogram_mrc``, ``voxelize_mesh`` on an icosphere,
   ``draw_filter_1d``), walls, and the three device tools card against
   CPU on a (64, 128, 128) crop.
10. ``-mesh`` in a multi-process cluster (``parallel/distributed``), each
    rank a child process (``cluster_rank``) with the VISFD_* variables
    set and a timeout; a rank that fails or hangs fails the phase:
    (10a) two ranks on the one card over gloo, each with blocks on
    ``["cuda:0"] * 2`` (the (2, 2) grid of 5c), run 5c's command with
    ``-mesh -1`` on 5c's input: the output equals 5c's ``-mesh 4``
    output bit for bit, rank 1 writes nothing, each per-shard kernel
    launches once per block of each rank; per rank the wall, the gather
    and its exchanges, the halo exchanges (seconds and bytes), the peak
    card memory and the host peak RSS; (10b) the same two ranks with
    ``-connect T -connect-angle 30`` on 6c's input and T, and with
    ``-select-cluster 1 -normals-file`` at 7d's normals size, and
    ``-ggauss 2`` on 6c's input (the dense kernel over blocks with halos
    from the other rank): labels, PLY and filter output equal the
    one-process ``-mesh 4`` run's; (10c) one rank over
    NCCL, 5c's ``-mesh 4`` over ``["cuda:0"] * 4``, equal to 5c, and two
    NCCL ranks on the one card refused with the cause named (two-rank
    NCCL needs two cards and is not verified here); (10d)
    ``entry.dryrun_multichip(4)`` on the card; (10e)
    ``utils.profiling.device_trace`` around phase 3's command: the
    trace's kernel events and the card's busy share of the wall.
12. every other handler in a cluster: two gloo ranks on the one card,
    blocks on ``["cuda:0"] * 2`` each (``phase_cluster_handlers``, all
    commands in one spawn, the host's cores shared between the ranks):
    (12a) 8b's ``-blob`` at 1024 x 1024 x 256 with ``-mesh -1``, the
    list and the image bit for bit 8b's, each rank's ``blur3`` launches
    twice 8b's (one a block), the wall, the spans (LoG ladder, extremum
    test, candidate merge), the exchanges, peak card memory and host
    RSS, the card's free memory checked first; (12b)
    ``-watershed-device -watershed-hide-boundaries`` at 512 x 512 x 256
    against one process ``-mesh 4``, the bytes the pointer jumping's
    all-gather receives a rank; (12c) on 128 x 128 x 64 inputs (a
    phantom, a corner of 8b's input and 8b's blobs in it):
    ``-watershed-device`` with its boundaries, ``-find-minima``, the host
    ``-watershed``, ``-discard-blobs`` on 8b's list, ``-draw-spheres``,
    ``-distance-points``, ``-random-spheres`` and
    ``-blob-radial-intensity``, each against one process ``-mesh 4``;
    every file rank 0 writes (text lists included) compared, rank 1
    writing none.
13. the sharded phase checkpoint (``phase_checkpoint``), 5c's command on
    the first 128 planes of 5c's input (1024 x 1024 x 128, a 5 GiB
    checkpoint, so that the whole script writes under 45 GiB to its
    disk): (13a) one process, ``-mesh 4 -save-progress-sharded``
    with ``-save-progress`` (the ``.rec`` yardstick) in the same run: the
    save's seconds, bytes and GB/s, peak card memory and host RSS;
    ``load_sharded`` whole, bit for bit the arrays the run saved; ``-load-progress-sharded`` without a mesh and
    with ``-mesh 4``, equal outputs; (13b) two gloo ranks on the card
    save and load (each rank writes its own blocks, half the bytes, and
    exchanges nothing during the save and the load), equal to 13a's, and
    one process loads their checkpoint without a mesh, equal to 13a's.
    ``--nccl`` adds 13c: n NCCL ranks save, two ranks and one process
    ``-mesh 4`` load, every output equal, and the checkpoint's arrays
    equal those one process ``-mesh n`` computes without it.

A failed check is reported where it happens and the later phases still
run; the script then exits non-zero without a result line.  On success
the second-to-last line is a JSON summary of the kernels (each with its
time, its plain twin's, the least time the card could take for the same
work, where one PyTorch call computes the same function that call's
time, with ``library_shape`` the (Z, Y, X) it was timed on where that
is not the kernel's own input (null elsewhere), its largest absolute
and relative error over the checks, and its
launches in one run: the vote score with its vector has one entry for
one device, from 6c, and one per block, from 7d's ``-mesh`` run; the
blur's per-axis mode counts 8e's ``-gauss 21`` run, the dense kernel
8e's ``-ggauss`` run, its (1, Ky, Kx) mode 9a's ``-doggxy`` run and its
31^3 mode 9a's ``-template-gauss`` run, the blob extremum kernel 8b's
run; ``cluster_launches``: each
rank's launches in 10a and 12a), before it the card's name and power
limit and phase 13's numbers (``{"checkpoint": ...}``), and the last
line ``{"ok": true, "device": {...}}``.  Each phase prints its
seconds.  TF32
is turned off for cuDNN and matmuls (the twins use neither; the
library yardsticks are timed in float32).
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
MESH_SHAPE = (256, 1024, 1024)  # (Z, Y, X) of the -mesh run, phase 5
CARDS_SHAPE = (512, 1024, 1024)  # (Z, Y, X) of 5c's command in phase 11
MESH_DEVICES = 4                # a (2, 2) mesh

# what each kernel replaces: (name, CUDA source, TPU kernel)
KERNELS = {
    "blur3": ("visfd_tpu_torch/csrc/blur.cu",
              "visfd_tpu/ops/blur_pallas.py:51"),
    "hessian_principal": ("visfd_tpu_torch/csrc/eigen.cu",
                          "visfd_tpu/ops/eigen_pallas.py:225"),
    "tv_votes": ("visfd_tpu_torch/csrc/tv.cu",
                 "visfd_tpu/ops/tv_pallas.py:80"),
    "sym3_score": ("visfd_tpu_torch/csrc/eigen.cu",
                   "visfd_tpu/ops/eigen_pallas.py:418"),
    "hessian_principal_block": ("visfd_tpu_torch/csrc/eigen.cu",
                                "visfd_tpu/ops/eigen_pallas.py:352"),
    "tv_votes_prepadded": ("visfd_tpu_torch/csrc/tv.cu",
                           "visfd_tpu/ops/tv_pallas.py:423"),
    # the vote score with its principal eigenvector (the -connect path),
    # on one device and per block of a -mesh run
    "sym3_score+v": ("visfd_tpu_torch/csrc/eigen.cu",
                     "visfd_tpu/ops/eigen_pallas.py:418"),
    "sym3_score_sharded+v": ("visfd_tpu_torch/csrc/eigen.cu",
                             "visfd_tpu/ops/eigen_pallas.py:418"),
}

# The least time the card could take for a kernel's work: the larger of
# its bytes (each input read once, each output written once) over the
# memory rate and its float32 operations over the peak rate (the H100
# SXM's published 3.35 TB/s and 67 TFLOP/s outside the tensor cores, at
# 700 W).  Operations per voxel, counted from csrc/ (a product, a sum, a
# division, a square root, a comparison or a transcendental each count
# one; an FMA two):
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BLUR_OPS_PER_TAP = 2            # one FMA per tap per axis
HESSIAN_OPS = 25 + 90 + 43      # FD stencil, eigenvalues, eigenvector
SYM3_OPS = 90                   # eigenvalues
EIGVEC_OPS = 43                 # the principal eigenvector
SCORE_OPS = {"planar": 4, "linear": 3, "stick": 1, "vals": 0}
TV_OPS_PER_TAP = 33             # per non-zero source and tap (e = 4)
TV_DEN_OPS_PER_TAP = 2
BLOB_EXTREMUM_OPS = 48          # the 80-neighbour test and the sign test


def bound_ms(nbytes, nops):
    """(ms, "bytes" | "operations"): the least time for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tv_work(sal, n_out_vox, n_field_vox, hw, ratio, sigma, want_den):
    """(bytes, operations) of a voting call: the fields read once, the
    6|7 channels written once, and the taps of every non-zero source
    (the sum a receiver needs; the sparse kernel skips the rest)."""
    from visfd_tpu_torch.ops.tv_cuda import tv_tables
    w, _, _ = tv_tables(sigma, ratio)
    taps = int((w != 0).sum())
    nnz = int((sal != 0).sum())
    per_tap = TV_OPS_PER_TAP + (TV_DEN_OPS_PER_TAP if want_den else 0)
    nbytes = 4 * n_field_vox * (5 if want_den else 4) \
        + 4 * n_out_vox * (7 if want_den else 6)
    return nbytes, nnz * taps * per_tap


def occupancy(sal, hw):
    """Shares of a voting field that are non-zero at three granularities:
    voxels; (32 x 8 receiver tile, source plane) pairs whose haloed
    (32 + 2hw) x (8 + 2hw) tile holds a non-zero source (what a kernel
    that skips whole source planes per tile can skip); (32-receiver warp
    row, source row) pairs whose 32 + 2hw sources hold one (the rows a
    warp of csrc/tv.cu walks)."""
    import torch
    nz = (sal != 0).float()[None]
    k = 2 * hw + 1
    pool = torch.nn.functional.max_pool3d
    dil_x = pool(nz, (1, 1, k), 1, (0, 0, hw))
    tile = pool(pool(dil_x, (1, k, 1), 1, (0, hw, 0)), (1, 8, 32),
                (1, 8, 32), ceil_mode=True)
    row = pool(dil_x, (1, 1, 32), (1, 1, 32), ceil_mode=True)
    return {"voxels": float(nz.mean()), "tile_planes": float(tile.mean()),
            "warp_rows": float(row.mean())}


def _tv_best_field(shape, seed, dev):
    """(saliency, direction (3, Z, Y, X)) that ``filter_mrc -membrane
    minima 3 -tv-best 0.05`` votes on: the top 5% of a seeded phantom's
    planar score (blur and Hessian kernels, sort threshold, as in 5b)."""
    import torch
    from visfd_tpu_torch.ops import eigen_cuda as EC
    from visfd_tpu_torch.ops import filters as F
    from visfd_tpu_torch.parallel.reduce import fraction_threshold
    from visfd_tpu_torch.utils.phantom import membrane_phantom
    sigma = 3.0 / np.sqrt(3.0)
    vol, _ = membrane_phantom(shape, seed=seed, thickness=3.0, device=dev)
    blur = F.apply_gauss(vol, sigma, truncate_halfwidth=(4,) * 3)
    del vol
    score, v = EC.hessian_principal(blur, sigma)
    del blur
    thr = fraction_threshold(score, 0.05)
    return torch.where(score < thr, 0.0, score), v


def _occupancy_line(label, sal, hw):
    o = occupancy(sal, hw)
    return (f"  {label} occupancy (hw {hw}): voxels {o['voxels']:.4f}, "
            f"(32x8 tile, source plane) pairs {o['tile_planes']:.4f}, "
            f"(warp row, source row) pairs {o['warp_rows']:.4f}")


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
        returns None, so the later phases still report.  Prints the
        phase's seconds."""
        t0 = time.perf_counter()
        try:
            return phase(*args)
        except Exception:  # reported, and decides the exit code
            traceback.print_exc()
            self.check(False, f"{phase.__name__} raised")
            return None
        finally:
            print(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f} s)",
                  flush=True)


class Err(tuple):
    """A check's (max |got - want|, max |got - want| / max(|want|,
    scale)), scale = atol / rtol: the value below which the check holds
    a voxel to its absolute tolerance.  Formats as the first."""

    def __new__(cls, abs_err=0.0, rel_err=0.0):
        return super().__new__(cls, (float(abs_err), float(rel_err)))

    def __format__(self, spec):
        return format(self[0], spec)


def worst(*errs):
    """The larger absolute and the larger relative error of several
    checks (a bare number counts as an absolute error)."""
    errs = [e if isinstance(e, Err) else Err(e) for e in errs]
    return Err(max(e[0] for e in errs), max(e[1] for e in errs))


def close(got, want, rtol, atol_rel, absolute=False):
    """(ok, Err, atol) for float tensors on any device: |got - want| <=
    atol + rtol |want| everywhere, atol = atol_rel times the largest
    |want| (or atol_rel itself when ``absolute``).  Prints where it does
    not hold."""
    got, want = got.double(), want.double()
    atol = atol_rel if absolute else atol_rel * float(want.abs().max())
    diff = (got - want).abs()
    rel = diff / want.abs().clamp(min=max(atol / rtol, 1e-300))
    out = diff > atol + rtol * want.abs()
    if bool(out.any()):
        worst = int(((diff - atol) / want.abs().clamp(min=1e-30)).argmax())
        print(f"    {int(out.sum())} of {out.numel()} values out; max|want| "
              f"{float(want.abs().max()):.4g}; worst got "
              f"{float(got.reshape(-1)[worst]):.8g} want "
              f"{float(want.reshape(-1)[worst]):.8g}")
    return (not bool(out.any()), Err(float(diff.max()), float(rel.max())),
            atol)


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


def timed_ms(fn):
    """(fn(), milliseconds of that one call on the card, CUDA events):
    for the plain twins, which take seconds and are checked anyway."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


# ---------------------------------------------------------------------------

def library_ms(fn, t6):
    """One timed call of ``fn`` (torch.linalg.eigvalsh for the score, eigh
    for the score and vectors) on the (N, 3, 3) matrices of ``t6`` (built
    outside the timed call; stick = l2 - l1), after a warm-up on 1024 of
    them.  Through MAGMA: cuSOLVER's batched syev refuses batches of 2^16
    matrices and more (CUSOLVER_STATUS_INVALID_VALUE, torch 2.11 + CUDA
    12.8)."""
    import torch
    t = t6.reshape(6, -1)
    mats = torch.stack([t[0], t[3], t[5], t[3], t[1], t[4], t[5], t[4],
                        t[2]], dim=-1).reshape(-1, 3, 3)
    backend = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("magma")
    try:
        fn(mats[:1024])
        return timed_ms(lambda: fn(mats))[1]
    finally:
        torch.backends.cuda.preferred_linalg_library(backend)


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


def _kernel_name(mangled):
    """``name<template args>`` of a mangled kernel symbol (Itanium
    mangling: <length><name>, then I<args>E if a template)."""
    import re
    name, rest = mangled, ""
    for d in re.finditer(r"(?=(\d{1,3}))", mangled):
        end = d.start() + len(d.group(1))
        cand = mangled[end:end + int(d.group(1))]
        if "_kernel" in cand and cand.isidentifier():
            name, rest = cand, mangled[end + len(cand):]
    if name != mangled and rest.startswith("I"):
        args = re.findall(r"L([ib])(\d+)E", rest[:rest.find("EE") + 2])
        name += "<" + ", ".join(
            ("true" if v == "1" else "false") if t == "b" else v
            for t, v in args) + ">"
    return name


def _ptxas_report(text):
    """One line per compiled kernel from ptxas's -v output: the kernel
    (with its template arguments), registers, spills and stack."""
    import re
    lines, name, stack = [], None, ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill" in ln:
            stack = ln.split("info    :")[-1].strip()
        elif "Used" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            lines.append(f"{name}: {regs} registers; {stack}")
            name = None
    return lines


def sass_functions(so):
    """{kernel name: [(address, instruction)]} from ``cuobjdump -sass``
    of the built library, or None when the toolkit has no cuobjdump."""
    import re
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(exe):
        return None
    text = subprocess.run([exe, "-sass", str(so)], capture_output=True,
                          text=True, timeout=300).stdout
    funcs, cur = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(_kernel_name(m.group(1)), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", ln)
        if m and cur is not None and not m.group(2).startswith("NOP"):
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def _opcode(op):
    """The opcode of a SASS instruction: its first word after the
    predicate, if any."""
    return next(w for w in op.split() if not w.startswith("@"))


def _hot_path(main):
    """The addresses one pass through a kernel's main body executes when
    no slow path is taken: a forward conditional branch is taken when
    the code it skips holds a CALL or local memory outside the ranges
    its own forward branches skip (the math library's slow paths), else
    not; each loop body runs once."""
    import re
    addr = [a for a, _ in main]
    pos = {a: i for i, a in enumerate(addr)}

    def target(op):
        m = re.match(r"(@!?U?P\w+\s+)?BRA(\.\S+)?\s+(?:\S+,\s*)?"
                     r"(0x[0-9a-f]+)$", op)
        return (int(m.group(3), 16), m.group(1) is not None) if m else None

    def rare(i, j):
        while i < j:
            op = main[i][1]
            if _opcode(op).startswith(("CALL", "LDL", "STL")):
                return True
            t = target(op)
            nested = t and t[1] and i < pos.get(t[0], -1) <= j
            i = pos[t[0]] if nested else i + 1
        return False
    seen, i = [], 0
    while i < len(main) and len(seen) < 4 * len(main):
        a, op = main[i]
        seen.append(a)
        if op.split()[0] == "EXIT":
            break
        t = target(op)
        if t is None or t[0] not in pos or t[0] < a:
            i += 1                          # a loop's end: leave it
        elif not t[1] or rare(i + 1, pos[t[0]]):
            i = pos[t[0]]
        else:
            i += 1
    return seen, [target(op) for _, op in main]


def sass_counts(ins, voxels_per_pass):
    """Static counts of one kernel's SASS: instructions in all; the main
    body (up to the first unconditional EXIT; the math library's slow
    paths lie after it or are skipped by ``_hot_path``); per voxel, the
    instructions of the hot path (``_hot_path``), or for a kernel that
    loops over passes of ``voxels_per_pass`` voxels, those of the
    outermost loop's body over those voxels; MUFU, CALL and
    local-memory (LDL/STL) instructions."""
    main = []
    for a, op in ins:
        main.append((a, op))
        if op.split()[0] == "EXIT":
            break
    hot, targets = _hot_path(main)
    loops = [(t[0], a) for (a, _), t in zip(main, targets)
             if t and t[0] < a and a in hot]
    per_voxel = len(hot)
    if loops:
        lo, hi = min(loops, key=lambda l: l[0] - l[1])
        per_voxel = sum(lo <= a <= hi for a in hot) / voxels_per_pass
    ops = [_opcode(op) for _, op in ins]
    return {"all": len(ins), "main": len(main), "hot": len(hot),
            "per_voxel": per_voxel,
            "mufu": sum(o.startswith("MUFU") for o in ops),
            "call": sum(o.startswith("CALL") for o in ops),
            "local": sum(o.startswith(("LDL", "STL")) for o in ops)}


def _eigen_sass(so):
    """{eigen kernel instantiation: its SASS counts (``sass_counts``) as
    text}, or None when the toolkit has no cuobjdump."""
    import re
    funcs = sass_functions(so)
    if funcs is None:
        return None
    src = open(os.path.join(ROOT, "visfd_tpu_torch", "csrc",
                            "eigen.cu")).read()
    zt = re.search(r"constexpr int kZT = (\d+);", src)
    out = {}
    for name, ins in funcs.items():
        if not name.startswith(("hessian_principal", "sym3_score")):
            continue
        per_pass = int(zt.group(1)) if zt and "hessian" in name else 1
        c = sass_counts(ins, per_pass)
        out[name] = (f"SASS: {c['per_voxel']:.0f} instructions per voxel "
                     f"({per_pass} voxel(s) a pass), hot path {c['hot']}, "
                     f"main body {c['main']}, all {c['all']}; MUFU "
                     f"{c['mufu']}, CALL {c['call']}, LDL/STL {c['local']}")
    return out


def phase_build(chk):
    from visfd_tpu_torch import _cuda_build as cb
    print("== phase 1: build", flush=True)
    t0 = time.perf_counter()
    so = cb.build()
    cb.library()
    print(f"built {os.path.relpath(so, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in "
          f"parallel)")
    sass = _eigen_sass(so)
    if sass is None:
        print("  cuobjdump: absent from this CUDA toolkit; no SASS counts")
    log = so.with_suffix(".log")
    if log.exists():
        for ln in _ptxas_report(log.read_text()):
            name = ln.split(":")[0]
            print("  ptxas:", ln + (f"; {sass[name]}" if sass and name in sass
                                    else ""))
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


def _block_views(bp):
    """(block, z_lo, z_hi, y_lo, y_hi), the arguments of
    ``hessian_principal_block``, as views of a (Z+2, Y+2, X) tensor whose
    border planes and rows in z and y are the block's halos."""
    return bp[1:-1, 1:-1], bp[0], bp[-1], bp[1:-1, 0], bp[1:-1, -1]


def _tv_check(chk, label, got, got_den, raw):
    """Kernel votes (channel-major) against the twin's raw block: rtol
    2e-4, atol 2e-5 (or 2e-5 of the largest vote, if that is below 1)."""
    atol = 2e-5 * min(1.0, float(raw.abs().max()))
    ok, err, _ = close(got, raw[:6], 2e-4, atol, absolute=True)
    if got_den is not None:
        ok_d, err_d, _ = close(got_den, raw[6], 2e-4, atol, absolute=True)
        ok, err = ok and ok_d, worst(err, err_d)
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
    nvox = int(np.prod(shape))

    def record(name, err, ms=None, plain_ms=None, bound=None,
               library_ms=None, library_shape=None):
        s = stats.setdefault(name, {"err": Err()})
        s["err"] = worst(s["err"], err)
        if ms is not None:
            s.update(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                     bound_by=bound[1], library_ms=library_ms,
                     library_shape=library_shape)

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
        record("blur3", worst(err, err_m))
        if hw == 4:
            ms = cuda_ms(lambda: blur_cuda.blur3(x, ks), 20)
            pms = cuda_ms(lambda: blur_cuda.blur3_plain(x, ks), 5)
            # the library yardstick: one cuDNN conv3d with the outer
            # product of the taps, flipped (conv3d correlates)
            kx, ky, kz = ks
            k3 = (kz[:, None, None] * ky[None, :, None]
                  * kx[None, None, :]).flip(0, 1, 2)[None, None]
            conv3d = torch.nn.functional.conv3d
            lib = conv3d(x[None, None], k3, padding=hw)[0, 0]
            ok_l, err_l, _ = close(lib, got, 1e-4, 1e-5)
            chk.check(ok_l, f"conv3d (library yardstick) == blur3 hw=4 to "
                            f"rtol 1e-4: max|d|={err_l:.3g}")
            del lib
            lms = cuda_ms(lambda: conv3d(x[None, None], k3, padding=hw), 5)
            b = bound_ms(8 * nvox, 3 * BLUR_OPS_PER_TAP * (2 * hw + 1) * nvox)
            record("blur3", err, ms, pms, b, lms)
            print(f"  blur3 hw=4: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
                  f"conv3d {lms:.3f} ms, bound {b[0]:.3f} ms ({b[1]}) "
                  f"[{card}]")

    # --- Hessian + eigensolve: every formula, with the vector ----------
    # The eigen twins run on the CPU copy of the same input: torch's CUDA
    # sqrt is not correctly rounded (and its atan2/cos/sin differ from
    # the host's by an ulp), and the closed-form roots turn one ulp into
    # ~sqrt(eps) near a double eigenvalue.  The kernel uses IEEE sqrt and
    # the twin's order of operations, so it follows the host twin.
    blur = blur_cuda.blur3(x, [torch.as_tensor(K.gauss_kernel_1d(1.73, 4),
                                               device=dev)] * 3)
    # Here the main path's order only (each host twin takes tens of
    # seconds at this shape); 2b holds both orders.
    raw = EC.hessian_principal_plain(blur.cpu(), 1.73, True, "vals", True)
    for formula in ("planar", "linear", "stick", "vals"):
        s_k, v_k = EC.hessian_principal(blur, 1.73, True, formula, True)
        record("hessian_principal", _eigen_check(
            chk, f"hessian_principal {formula} decreasing=True", s_k, v_k,
            raw, formula))
    del raw
    ms = cuda_ms(lambda: EC.hessian_principal(blur, 1.73, True, "planar",
                                              True), 20)
    pms = cuda_ms(lambda: EC.hessian_principal_plain(blur, 1.73, True,
                                                     "planar", True), 3)
    b = bound_ms(20 * nvox, (HESSIAN_OPS + SCORE_OPS["planar"]) * nvox)
    record("hessian_principal", 0.0, ms, pms, b)
    print(f"  hessian_principal planar+v: kernel {ms:.3f} ms, plain "
          f"{pms:.3f} ms (on the card), bound {b[0]:.3f} ms ({b[1]}) "
          f"[{card}]")

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
    # the main path's field: what -tv-best 0.05 leaves of the phantom's
    # planar score, with its own directions
    sal_real, nv_real = _tv_best_field(shape, SEED, dev)
    print(_occupancy_line("-tv-best 0.05 field", sal_real, hw))
    kw = dict(exponent=4, truncate_ratio=ratio, channel_major=True,
              nvec_channel_major=True)
    cases = [("dense", sal_dense, nv, dict()),
             ("masked+denominator", sal_dense, nv,
              dict(mask_src=m, want_denominator=True)),
             ("curves", sal_dense, nv, dict(detect_curves=True)),
             ("planes 5%", sal_planes, nv, dict()),
             ("-tv-best 0.05", sal_real, nv_real, dict())]
    # the twin (seconds a call) on the dense field and the main path's;
    # 2b holds the mask, the denominator and curves against it
    twin_ms = {}
    for label, sal, nvc, extra in cases:
        got, got_den = tv_votes(sal, nvc, sigma, **kw, **extra)
        if label in ("dense", "-tv-best 0.05"):
            raw, twin_ms[label] = timed_ms(lambda: _tv_twin(
                sal, nvc, sigma, ratio, **extra))
            record("tv_votes", _tv_check(chk, f"tv_votes hw=3 e=4 {label}",
                                         got, got_den, raw))
            del raw
        sp, sp_den = tv_votes(sal, nvc, sigma, sparse=True, **kw, **extra)
        _sparse_equals_dense(chk, f"tv_votes {label}", sp, sp_den, got,
                             got_den)
        del got, got_den, sp, sp_den
    timed = {}
    for label, sal, nvc in (("-tv-best 0.05", sal_real, nv_real),
                            ("planes", sal_planes, nv),
                            ("dense", sal_dense, nv)):
        ms = cuda_ms(lambda: tv_votes(sal, nvc, sigma, **kw), 5)
        ms_sp = cuda_ms(lambda: tv_votes(sal, nvc, sigma, sparse=True,
                                         **kw), 5)
        b = bound_ms(*tv_work(sal, nvox, nvox, hw, ratio, sigma, False))
        timed[label] = (ms, ms_sp, b)
        print(f"  tv_votes hw=3 e=4, {label} field "
              f"({float((sal != 0).float().mean()):.4f} occupied): dense "
              f"kernel {ms:.3f} ms, sparse kernel {ms_sp:.3f} ms, bound "
              f"{b[0]:.3f} ms ({b[1]}) [{card}]", flush=True)
    # the kernels line: the main path's mode (sparse) on its field
    _, ms_sp, b = timed["-tv-best 0.05"]
    pms = twin_ms["-tv-best 0.05"]
    record("tv_votes", 0.0, ms_sp, pms, b)
    print(f"  tv_votes plain twin on the -tv-best 0.05 field {pms:.3f} ms "
          f"[{card}]")
    del sal_real, nv_real, sal_planes

    # --- sym3 score of the vote tensor: stick, with v -------------------
    # (the twin on the CPU copy, as for the Hessian kernel)
    vote, _ = tv_votes(sal_dense, nv, sigma, **kw)
    s_k, v_k = EC.sym3_score(vote, True, "stick", True)
    raw = EC.sym3_score_plain(vote.cpu(), True, "vals", True)
    err = _eigen_check(chk, "sym3_score stick+v", s_k, v_k, raw, "stick")
    record("sym3_score", err)
    record("sym3_score+v", err)
    ms = cuda_ms(lambda: EC.sym3_score(vote, True, "stick", False), 20)
    pms = cuda_ms(lambda: EC.sym3_score_plain(vote, True, "stick", False),
                  3)
    ms_v = cuda_ms(lambda: EC.sym3_score(vote, True, "stick", True), 20)
    pms_v = cuda_ms(lambda: EC.sym3_score_plain(vote, True, "stick", True),
                    3)
    b_v = bound_ms(40 * nvox, (SYM3_OPS + SCORE_OPS["stick"] + EIGVEC_OPS)
                   * nvox)
    print(f"  sym3_score stick+v: kernel {ms_v:.3f} ms, plain {pms_v:.3f} ms "
          f"(on the card), bound {b_v[0]:.3f} ms ({b_v[1]}), "
          f"{b_v[0] / ms_v:.0%} of it [{card}]", flush=True)
    del raw, s_k, v_k
    b = bound_ms(28 * nvox, (SYM3_OPS + SCORE_OPS["stick"]) * nvox)
    print(f"  sym3_score stick: kernel {ms:.3f} ms, plain {pms:.3f} ms "
          f"(on the card), bound {b[0]:.3f} ms ({b[1]}), {b[0] / ms:.0%} of "
          f"it [{card}]", flush=True)

    # MAGMA's eigvalsh / eigh on the first 32nd of the planes (on all of
    # them eigvalsh takes 45-72 s and eigh about two and a half minutes);
    # the kernels line gives that shape beside library_ms
    slab = vote[:, :vote.shape[1] // 32].contiguous()
    lms = library_ms(torch.linalg.eigvalsh, slab)
    lms_v = library_ms(torch.linalg.eigh, slab)
    lshape = list(slab.shape[1:])
    record("sym3_score", 0.0, ms, pms, b, lms, lshape)
    record("sym3_score+v", 0.0, ms_v, pms_v, b_v, lms_v, lshape)
    print(f"  on {tuple(lshape)}: eigvalsh {lms:.3f} ms, eigh {lms_v:.3f} ms "
          f"[{card}]", flush=True)
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
        errs[name] = worst(errs.get(name, Err()), err)

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
        # the per-shard entry: x as the block, read through a strided
        # view of a larger tensor whose border rows are its halo slabs
        xp = rng.normal(size=(shape[0] + 2, shape[1] + 2, shape[2]))
        xp[1:-1, 1:-1] = x
        xp = xp.astype(np.float32)
        halo_views = _block_views(torch.tensor(xp, device=dev))
        for decreasing in (True, False):
            raw = EC.hessian_principal_plain(torch.tensor(x), 1.7,
                                             decreasing, "vals", True)
            raw_b = EC.hessian_principal_block_plain(
                *_block_views(torch.tensor(xp)), 1.7, decreasing, "vals",
                True)
            t6 = rng.normal(size=(6,) + shape).astype(np.float32)
            raw6 = EC.sym3_score_plain(torch.tensor(t6), decreasing,
                                       "vals", True)
            for formula in ("planar", "linear", "stick", "vals"):
                for want_v in (True, False):
                    tag = (f"{formula}{'+v' if want_v else ''} "
                           f"decreasing={decreasing}")
                    s_k, v_k = EC.hessian_principal(xc, 1.7, decreasing,
                                                    formula, want_v)
                    record("hessian_principal", _eigen_check(
                        chk, f"{shape} hessian_principal {tag}", s_k, v_k,
                        raw, formula))
                    out = EC.hessian_principal_block(*halo_views, 1.7,
                                                     decreasing, formula,
                                                     want_v)
                    s_k, v_k = EC._split(out, formula, want_v)
                    record("hessian_principal_block", _eigen_check(
                        chk, f"{shape} hessian_principal_block {tag}", s_k,
                        v_k, raw_b, formula))
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
        errs[name] = worst(errs.get(name, Err()), err)
    return errs


def phase_main_path(chk, card, tmp, shapes=(MAIN_SHAPE, (128, 256, 256)),
                    dev="cuda"):
    import inspect
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
        for name, fn, a_, kw_, _ in cap.calls:
            if name == "tv_votes":
                a = inspect.signature(fn).bind(*a_, **kw_)
                a.apply_defaults()
                hw = tv_cuda.tv_tables(a.arguments["sigma"],
                                       a.arguments["truncate_ratio"])[2]
                print(_occupancy_line("the CLI's voting field",
                                      a.arguments["saliency"], hw))
        for k, e in _check_captured(chk, cap.calls).items():
            errs[k] = worst(errs.get(k, Err()), e)
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


# ---------------------------------------------------------------------------
# phase 5: the -mesh path

def _mesh(n=MESH_DEVICES):
    """The phase's (2, 2) mesh: the blocks on the visible cards in turn
    (all on cuda:0 with one card)."""
    import torch
    from visfd_tpu_torch.parallel.mesh import make_mesh
    cards = torch.cuda.device_count()
    return make_mesh(n, devices=[f"cuda:{i % cards}" for i in range(n)])


def _whole(vol, dev="cuda:0"):
    """A ShardedVolume assembled into one tensor on ``dev``."""
    import torch
    out = torch.empty(vol.shape, device=dev)
    bz, by = vol.block_shape
    pre = (slice(None),) * vol.lead
    for iz, iy, b in vol.cells():
        out[pre + (slice(iz * bz, (iz + 1) * bz),
                   slice(iy * by, (iy + 1) * by))].copy_(b)
    return out


def _bits_differ(a, b) -> int:
    """How many float32 values of ``a`` and ``b`` (a tensor, or a
    ShardedVolume held against the whole tensor) differ in any bit
    (-0.0 != +0.0); counted slab by slab to bound the memory."""
    import torch
    from visfd_tpu_torch.parallel.mesh import ShardedVolume
    if isinstance(a, ShardedVolume):
        bz, by = a.block_shape
        pre = (slice(None),) * a.lead
        return sum(_bits_differ(blk, b[pre + (
            slice(iz * bz, (iz + 1) * bz), slice(iy * by, (iy + 1) * by))])
            for iz, iy, blk in a.cells())
    return sum(int(torch.count_nonzero(x.view(torch.int32)
                                       != y.view(torch.int32)))
               for x, y in zip(a, b.to(a.device)))


def _max_diff(a, b) -> Err:
    """The Err of a ShardedVolume ``a`` held against the whole tensor
    ``b`` (its largest |a - b|, and that over the largest |b|), block by
    block and channel by channel."""
    bz, by = a.block_shape
    pre = (slice(None),) * a.lead
    d = top = 0.0
    for iz, iy, blk in a.cells():
        want = b[pre + (slice(iz * bz, (iz + 1) * bz),
                        slice(iy * by, (iy + 1) * by))]
        for x, y in zip(blk.reshape((-1,) + blk.shape[-3:]),
                        want.reshape((-1,) + want.shape[-3:])):
            d = max(d, float((x - y.to(x.device)).abs().max()))
            top = max(top, float(y.abs().max()))
    return Err(d, d / max(top, 1e-30))


def phase_mesh_kernels(chk, card, dev="cuda"):
    """5a: the per-shard modes against their twins on one block of the
    mesh run, with its halos; timed beside the single-device kernels on
    as many voxels."""
    import torch
    from visfd_tpu_torch.ops import blur_cuda, eigen_cuda as EC
    from visfd_tpu_torch.ops import kernels as K
    from visfd_tpu_torch.ops.tv_cuda import (
        _tv_votes_prepadded_plain, tv_votes, tv_votes_prepadded)

    nz, ny, nx = MESH_SHAPE
    block = (nz // 2, ny // 2, nx)
    nvox = int(np.prod(block))
    print(f"== phase 5a: per-shard kernels against their twins, block "
          f"(Z, Y, X) = {block} with halos [{card}]", flush=True)
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    stats = {}

    # --- Hessian + eigensolve: a block read in place beside its halo
    #     slabs, each a tensor of its own as the sharded path hands them
    #     over; then the JAX package's interface, a padded block ---------
    x = torch.randn((block[0] + 2, block[1] + 2, block[2] + 2),
                    generator=gen, device=dev)
    bp = blur_cuda.blur3(x, [torch.as_tensor(K.gauss_kernel_1d(1.73, 4),
                                             device=dev)] * 3)
    del x
    parts = [t.contiguous() for t in _block_views(bp[:, :, 1:-1])]
    raw = EC.hessian_principal_block_plain(*[t.cpu() for t in parts], 1.73,
                                           True, "vals", True)
    out = EC.hessian_principal_block(*parts, 1.73, True, "planar", True)
    err = _eigen_check(chk, f"hessian_principal_block planar+v {block}",
                       out[0], out[1:4], raw, "planar")
    out = EC.hessian_principal_prepadded(bp, 1.73, True, "planar", True)
    err = worst(err, _eigen_check(
        chk, f"hessian_principal_prepadded planar+v {block}", out[0],
        out[1:4], raw, "planar"))
    del raw, out
    inner = parts[0]
    ms = cuda_ms(lambda: EC.hessian_principal_block(*parts, 1.73), 10)
    ms_pad = cuda_ms(lambda: EC.hessian_principal_prepadded(bp, 1.73), 10)
    ms1 = cuda_ms(lambda: EC.hessian_principal(inner, 1.73), 10)
    pms = cuda_ms(lambda: EC.hessian_principal_block_plain(*parts, 1.73), 2)
    b = bound_ms(4 * sum(t.numel() for t in parts) + 16 * nvox,
                 (HESSIAN_OPS + SCORE_OPS["planar"]) * nvox)
    stats["hessian_principal_block"] = dict(
        err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
        library_ms=None)
    print(f"  hessian_principal_block planar+v: kernel {ms:.3f} ms "
          f"(through hessian_principal_prepadded on views of a padded "
          f"block {ms_pad:.3f} ms), single-device kernel on the same "
          f"voxels {ms1:.3f} ms, plain {pms:.3f} ms (on the card), bound "
          f"{b[0]:.3f} ms ({b[1]}), {b[0] / ms:.0%} of it [{card}]")
    del bp, parts, inner

    # --- voting on hw-haloed fields: masked + denominator, then the
    #     main path's sparse mode on the -tv-best 0.05 field of a block -
    hw = 3
    sigma = hw / np.sqrt(2.0) + 1e-6
    ratio = float(np.sqrt(2.0))
    pshape = tuple(n + 2 * hw for n in block)
    u = torch.rand(pshape, generator=gen, device=dev)
    sal = torch.where(u > 0.4, u, 0.0)
    m = (torch.rand(pshape, generator=gen, device=dev) > 0.2).float()
    nv = torch.randn((3,) + pshape, generator=gen, device=dev)
    nv = nv / nv.norm(dim=0, keepdim=True)
    kw = dict(exponent=4, truncate_ratio=ratio, channel_major=True,
              nvec_channel_major=True)
    got, got_den = tv_votes_prepadded(sal, nv, sigma, block, mask_pad=m,
                                      want_denominator=True, **kw)
    raw = _tv_votes_prepadded_plain(sal, nv, m, block, sigma, 4, False,
                                    ratio, True)
    err_tv = _tv_check(chk, f"tv_votes_prepadded hw=3 e=4 masked+"
                            f"denominator {block}", got, got_den, raw)
    del raw
    sp, sp_den = tv_votes_prepadded(sal, nv, sigma, block, mask_pad=m,
                                    want_denominator=True, sparse=True, **kw)
    _sparse_equals_dense(chk, "tv_votes_prepadded", sp, sp_den, got,
                         got_den)
    del got, got_den, sp, sp_den, m, sal
    z = torch.arange(pshape[0], device=dev)[:, None, None]
    planes = torch.where(z % 20 == 0, u, 0.0)
    del u
    ms_pl = cuda_ms(lambda: tv_votes_prepadded(planes, nv, sigma, block,
                                               sparse=True, **kw), 5)
    print(f"  tv_votes_prepadded hw=3 e=4 sparse, planes field "
          f"({float((planes != 0).float().mean()):.4f} occupied): kernel "
          f"{ms_pl:.3f} ms [{card}]")
    del planes, nv
    # the block's -tv-best 0.05 field: a phantom of the haloed block's
    # shape, so its halos hold sources as a mesh block's do
    real, real_v = _tv_best_field(pshape, SEED + 50, dev)
    print(_occupancy_line("block's -tv-best 0.05 field", real, hw))
    raw, pms = timed_ms(lambda: _tv_votes_prepadded_plain(
        real, real_v, None, block, sigma, 4, False, ratio, False))
    got, _ = tv_votes_prepadded(real, real_v, sigma, block, sparse=True,
                                **kw)
    err_tv = worst(err_tv, _tv_check(
        chk, f"tv_votes_prepadded sparse, -tv-best 0.05 field {block}",
        got, None, raw))
    del raw
    dense, _ = tv_votes_prepadded(real, real_v, sigma, block, **kw)
    _sparse_equals_dense(chk, "tv_votes_prepadded -tv-best 0.05", got, None,
                         dense, None)
    del got, dense
    ms = cuda_ms(lambda: tv_votes_prepadded(real, real_v, sigma, block,
                                            sparse=True, **kw), 5)
    inner_s = real[hw:-hw, hw:-hw, hw:-hw].contiguous()
    inner_n = real_v[:, hw:-hw, hw:-hw, hw:-hw].contiguous()
    ms1 = cuda_ms(lambda: tv_votes(inner_s, inner_n, sigma, sparse=True,
                                   **kw), 5)
    del inner_s, inner_n
    b = bound_ms(*tv_work(real, nvox, real.numel(), hw, ratio, sigma,
                          False))
    stats["tv_votes_prepadded"] = dict(
        err=err_tv, ms=ms, plain_ms=pms, bound_ms=b[0],
        bound_by=b[1], library_ms=None)
    print(f"  tv_votes_prepadded hw=3 e=4 sparse, -tv-best 0.05 field "
          f"({float((real != 0).float().mean()):.4f} occupied): kernel "
          f"{ms:.3f} ms, single-device kernel on the same voxels "
          f"{ms1:.3f} ms, plain {pms:.3f} ms, bound {b[0]:.3f} ms ({b[1]}) "
          f"[{card}]", flush=True)
    return stats


def phase_mesh_small(chk, card, dev="cuda"):
    """5a, continued: the sharded wrappers (halo exchange + per-shard
    kernels) on small volumes whose blocks are 1, 2 and 3 voxels thick,
    under a vote halo deeper than a block: bit for bit against the
    single-device kernels, and against the plain twins to the kernels'
    tolerances.  Returns max |d| per kernel."""
    import torch
    from visfd_tpu_torch.ops import eigen_cuda as EC
    from visfd_tpu_torch.ops.tv_cuda import _tv_votes_plain, tv_votes
    from visfd_tpu_torch.parallel import sharded as SH
    from visfd_tpu_torch.parallel.mesh import Mesh, shard

    print(f"== phase 5a: sharded wrappers on thin blocks [{card}]",
          flush=True)
    rng = np.random.default_rng(SEED + 51)
    dev = torch.device(dev)
    errs = {}
    cases = [
        # (Z, Y, X), mesh grid, vote hw, exponent, curves, masked
        ((4, 6, 37), (4, 2), 3, 4, False, True),    # blocks (1, 3)
        ((6, 4, 45), (3, 2), 2, 4, True, False),    # blocks (2, 2)
        ((9, 9, 29), (3, 3), 3, 3, False, False),   # blocks (3, 3)
        ((3, 8, 70), (1, 4), 3, 4, False, True),    # blocks (3, 2)
    ]
    for shape, grid, hw, e, curves, masked in cases:
        mesh = Mesh(tuple((dev,) * grid[1] for _ in range(grid[0])))
        label = (f"{shape} on {grid}, blocks "
                 f"{(shape[0] // grid[0], shape[1] // grid[1])}")
        x = rng.normal(size=shape).astype(np.float32)
        xc = torch.tensor(x, device=dev)
        formula = "linear" if curves else "planar"
        s1, v1 = EC.hessian_principal(xc, 1.7, formula=formula)
        ss, vs = SH.hessian_principal_sharded(shard(xc, mesh), 1.7,
                                              formula=formula)
        ss, vs = _whole(ss), _whole(vs)
        nd = _bits_differ(ss, s1) + _bits_differ(vs, v1)
        chk.check(nd == 0, f"{label} hessian sharded == single-device "
                           f"kernel: {nd} values differ")
        raw = EC.hessian_principal_plain(torch.tensor(x), 1.7, True, "vals",
                                         True)
        errs["hessian_principal_block"] = worst(
            errs.get("hessian_principal_block", Err()), _eigen_check(
                chk, f"{label} hessian sharded {formula}", ss, vs, raw,
                formula))
        sal = torch.where(ss > ss.quantile(0.5), ss, 0.0)
        m = torch.tensor((rng.uniform(size=shape) > 0.25).astype(
            np.float32), device=dev) if masked else None
        sigma = hw / np.sqrt(2.0) + 1e-6
        ratio = float(np.sqrt(2.0))
        kw = dict(exponent=e, detect_curves=curves, truncate_ratio=ratio,
                  want_denominator=masked, channel_major=True,
                  nvec_channel_major=True)
        want, want_den = tv_votes(sal, v1, sigma, mask_src=m, **kw)
        raw = _tv_votes_plain(sal, v1, m, sigma, e, curves, ratio, masked)
        for sparse in (False, True):
            got, got_den = SH.tv_accumulate_sharded(
                shard(sal, mesh), shard(v1, mesh, lead=1),
                None if m is None else shard(m, mesh), sigma, e, curves,
                ratio, masked, sparse=sparse)
            got = _whole(got)
            got_den = None if got_den is None else _whole(got_den)
            nd = _bits_differ(got, want) + (
                0 if got_den is None else _bits_differ(got_den, want_den))
            tag = (f"{label} votes hw={hw} e={e}"
                   f"{' curves' if curves else ''}"
                   f"{' masked+denominator' if masked else ''}"
                   f"{' sparse' if sparse else ' dense'}")
            chk.check(nd == 0, f"{tag} sharded == single-device kernel: "
                               f"{nd} values differ")
            errs["tv_votes_prepadded"] = worst(
                errs.get("tv_votes_prepadded", Err()),
                _tv_check(chk, f"{tag} sharded", got, got_den, raw))
        sc1, _ = EC.sym3_score(want, formula="linear" if curves else "stick")
        scs, _ = SH.sym3_score_sharded(shard(want, mesh, lead=1),
                                       formula="linear" if curves
                                       else "stick")
        nd = _bits_differ(_whole(scs), sc1)
        chk.check(nd == 0, f"{label} vote score sharded == single-device "
                           f"kernel: {nd} values differ")
    return errs


def phase_mesh_stages(chk, card, dev="cuda"):
    """5b: every sharded stage against its single-device counterpart on
    the card at MESH_SHAPE, each fed the same inputs; counts the voxels
    whose bits differ and times both.  Returns the stats of the
    per-block vote score with its vector (``sym3_score_sharded+v``)."""
    import torch
    from visfd_tpu_torch.ops import eigen_cuda as EC
    from visfd_tpu_torch.ops import filters as F
    from visfd_tpu_torch.ops.tv_cuda import tv_votes
    from visfd_tpu_torch.parallel import sharded as SH
    from visfd_tpu_torch.parallel.halo import face_halos, halo_pad_2d
    from visfd_tpu_torch.parallel.reduce import fraction_threshold
    from visfd_tpu_torch.parallel.mesh import shard
    from visfd_tpu_torch.utils.phantom import membrane_phantom

    mesh = _mesh()
    print(f"== phase 5b: sharded stages against single-device ones, "
          f"(Z, Y, X) = {MESH_SHAPE}, mesh {mesh.shape} on "
          f"{sorted({str(d) for r in mesh.devices for d in r})} [{card}]",
          flush=True)
    dev = torch.device(dev)
    vol, _ = membrane_phantom(MESH_SHAPE, seed=SEED + 52, thickness=3.0,
                              device=dev)
    sigma, hwb = 3.0 / np.sqrt(3.0), 4
    times = {}

    def both(name, single, sharded, reps=3):
        t1 = cuda_ms(single, reps)
        t4 = cuda_ms(sharded, reps)
        times[name] = (t1, t4)
        print(f"  {name}: single device {t1:.3f} ms, sharded {t4:.3f} ms "
              f"[{card}]", flush=True)

    # blur
    blur = F.apply_gauss(vol, sigma, truncate_halfwidth=(hwb,) * 3)
    xs = shard(vol, mesh)
    nd = _bits_differ(F.apply_gauss(xs, sigma, truncate_halfwidth=(
        hwb,) * 3), blur)
    chk.check(nd == 0, f"blur sharded == single device: {nd} voxels differ")
    both("blur (hw 4)",
         lambda: F.apply_gauss(vol, sigma, truncate_halfwidth=(hwb,) * 3),
         lambda: F.apply_gauss(xs, sigma, truncate_halfwidth=(hwb,) * 3))
    del vol, xs

    # Hessian + eigensolve
    score, v = EC.hessian_principal(blur, sigma)
    bs = shard(blur, mesh)
    ss, vs = SH.hessian_principal_sharded(bs, sigma)
    nd = _bits_differ(ss, score) + _bits_differ(vs, v)
    chk.check(nd == 0, f"hessian sharded == single device: {nd} values "
                       f"differ")
    del ss, vs
    both("hessian_principal planar+v",
         lambda: EC.hessian_principal(blur, sigma),
         lambda: SH.hessian_principal_sharded(bs, sigma))
    t1, t4 = times["hessian_principal planar+v"]
    face_ms = cuda_ms(lambda: [face_halos(bs, iz, iy)
                               for iz, iy, _ in bs.cells()], 3)
    print(f"  hessian stage sharded / single device: {t4 / t1:.3f}; the "
          f"halo slabs of the {len(bs.blocks) * len(bs.blocks[0])} blocks "
          f"(face_halos) {face_ms:.3f} ms [{card}]")
    del bs, blur

    # the -tv-best threshold: sort against radix selection over blocks
    sc_s = shard(score, mesh)
    thr = fraction_threshold(score, 0.05)
    thr_s = fraction_threshold(sc_s, 0.05)
    chk.check(np.float32(thr).view(np.int32)
              == np.float32(thr_s).view(np.int32),
              f"-tv-best 0.05 threshold: single device {thr!r}, mesh "
              f"{thr_s!r}")
    both("threshold (sort / radix)", lambda: fraction_threshold(score, 0.05),
         lambda: fraction_threshold(sc_s, 0.05), reps=2)
    del sc_s
    sal = torch.where(score < thr, 0.0, score)
    del score

    # voting, sparse (the main path) and dense; hw 3
    hw = 3
    tv_sigma = hw / np.sqrt(2.0) + 1e-6
    ratio = float(np.sqrt(2.0))
    vote, _ = tv_votes(sal, v, tv_sigma, truncate_ratio=ratio, sparse=True,
                       channel_major=True, nvec_channel_major=True)
    sal_s, v_s = shard(sal, mesh), shard(v, mesh, lead=1)
    for sparse in (True, False):
        got, _ = SH.tv_accumulate_sharded(sal_s, v_s, None, tv_sigma, 4, False,
                                          ratio, False, sparse=sparse)
        nd = _bits_differ(got, vote)
        del got
        chk.check(nd == 0, f"votes sharded {'sparse' if sparse else 'dense'}"
                           f" == single device (sparse): {nd} values differ")
    both("tv sparse (hw 3)",
         lambda: tv_votes(sal, v, tv_sigma, truncate_ratio=ratio,
                          sparse=True, channel_major=True,
                          nvec_channel_major=True),
         lambda: SH.tv_accumulate_sharded(sal_s, v_s, None, tv_sigma, 4,
                                          False, ratio, False, sparse=True),
         reps=2)
    halo_ms = cuda_ms(lambda: (halo_pad_2d(sal_s, hw, hw),
                               halo_pad_2d(v_s, hw, hw)), 3)
    print(f"  halo copies of the voting's inputs (saliency + direction, "
          f"{hw} rows): {halo_ms:.3f} ms [{card}]")
    del sal, v, sal_s, v_s

    # the vote tensor's score
    s1, _ = EC.sym3_score(vote)
    vote_s = shard(vote, mesh, lead=1)
    s4, _ = SH.sym3_score_sharded(vote_s)
    nd = _bits_differ(s4, s1)
    chk.check(nd == 0, f"vote score sharded == single device: {nd} voxels "
                       f"differ")
    both("sym3_score stick", lambda: EC.sym3_score(vote),
         lambda: SH.sym3_score_sharded(vote_s))
    nvox = vote[0].numel()
    b = bound_ms(28 * nvox, (SYM3_OPS + SCORE_OPS["stick"]) * nvox)
    t1 = times["sym3_score stick"][0]
    print(f"  sym3_score stick at {nvox} voxels: bound {b[0]:.3f} ms "
          f"({b[1]}), the single-device kernel {b[0] / t1:.0%} of it; "
          f"{float((vote == 0).all(0).float().mean()):.4f} of the voxels' "
          f"vote tensors are zero [{card}]")
    del s1, s4

    # with the vector, per block (the -connect -mesh path): bit for bit
    # the single-device kernel's, and one block's first planes against
    # the plain twin (voxelwise, so a slab of planes stands for the block)
    s1, v1 = EC.sym3_score(vote, want_v=True)
    s4, v4 = SH.sym3_score_sharded(vote_s, want_v=True)
    nd = _bits_differ(s4, s1) + _bits_differ(v4, v1)
    chk.check(nd == 0, f"vote score + vector sharded == single device: "
                       f"{nd} values differ")
    err = worst(_max_diff(s4, s1), _max_diff(v4, v1))
    del s1, v1
    blk = vote_s.blocks[0][0]
    slab = blk[:, :16].contiguous()
    raw = EC.sym3_score_plain(slab.cpu(), True, "vals", True)
    err = worst(err, _eigen_check(
        chk, f"sym3_score_sharded stick+v, block (0, 0) of "
             f"{tuple(blk.shape[1:])}, planes 0-15", s4.blocks[0][0][:16],
        v4.blocks[0][0][:, :16], raw, "stick"))
    del s4, v4, raw
    t_v = cuda_ms(lambda: EC.sym3_score(vote, want_v=True), 3)
    t_blk = cuda_ms(lambda: SH.sym3_score_sharded(vote_s, want_v=True), 3)
    b = bound_ms(40 * nvox, (SYM3_OPS + SCORE_OPS["stick"] + EIGVEC_OPS)
                 * nvox)
    print(f"  sym3_score stick+v at {nvox} voxels (the -connect path): "
          f"kernel {t_v:.3f} ms, sharded {t_blk:.3f} ms, bound {b[0]:.3f} ms "
          f"({b[1]}), {b[0] / t_v:.0%} of it [{card}]", flush=True)
    del vote_s
    # the kernels line: kernel, twin and eigh on the slab (eigh on a whole
    # block would take about four minutes)
    nv_s = slab[0].numel()
    ms = cuda_ms(lambda: EC.sym3_score(slab, True, "stick", True), 20)
    pms = cuda_ms(lambda: EC.sym3_score_plain(slab, True, "stick", True), 3)
    lms = library_ms(torch.linalg.eigh, slab)
    b = bound_ms(40 * nv_s, (SYM3_OPS + SCORE_OPS["stick"] + EIGVEC_OPS)
                 * nv_s)
    print(f"  sym3_score_sharded stick+v, a block's planes 0-15 "
          f"{tuple(slab.shape[1:])}: kernel {ms:.3f} ms, plain {pms:.3f} ms "
          f"(on the card), eigh {lms:.3f} ms, bound {b[0]:.3f} ms ({b[1]}), "
          f"{b[0] / ms:.0%} of it [{card}]", flush=True)
    return {"sym3_score_sharded+v": dict(
        err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
        library_ms=lms)}


def phase_mesh_cli(chk, card, tmp, dev="cuda"):
    """5c: the -mesh CLI against the single-device CLI at MESH_SHAPE.
    Returns (the -mesh run's launch counts, (its input file, its output
    file)): phase 10 runs the same command in a cluster."""
    import torch
    from visfd_tpu_torch.cli import filter_mrc as TFM
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.ops import blur_cuda, eigen_cuda as EC
    from visfd_tpu_torch.ops import tv_cuda
    from visfd_tpu_torch.utils.phantom import membrane_phantom
    from visfd_tpu_torch.utils.progress import Report

    mesh_devs = [d for row in _mesh().devices for d in row]
    shape = MESH_SHAPE
    print(f"== phase 5c: filter_mrc -mesh {MESH_DEVICES}, "
          f"{'x'.join(map(str, shape[::-1]))} (X x Y x Z), blocks on "
          f"{[str(d) for d in mesh_devs]} [{card}]", flush=True)
    wrappers = {"blur3": blur_cuda.blur3,
                "hessian_principal": EC.hessian_principal,
                "hessian_principal_block": EC.hessian_principal_block,
                "tv_votes": tv_cuda.tv_votes,
                "tv_votes_prepadded": tv_cuda.tv_votes_prepadded,
                "sym3_score": EC.sym3_score}
    vol, dist = membrane_phantom(shape, seed=SEED + 53, thickness=3.0,
                                 device=dev)
    fin = os.path.join(tmp, "mesh_in.mrc")
    mrc.write_mrc(fin, vol.cpu().numpy())
    del vol
    args = "-w 1 -membrane minima 3 -tv 1.5 -tv-angle-exponent 4"
    outs, launches = {}, {}
    for label, extra in (("-mesh", ["-mesh", str(MESH_DEVICES)]),
                         ("single device", [])):
        fout = os.path.join(tmp, f"mesh_out{len(outs)}.mrc")
        for w in wrappers.values():
            w.launches = 0
        cards = range(torch.cuda.device_count())
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        rep = Report(None)
        t0 = time.perf_counter()
        rc = TFM.run(["-in", fin, "-out", fout] + args.split() + extra,
                     device=dev, report=rep, mesh_devices=mesh_devs)
        wall = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        peak = max(torch.cuda.max_memory_allocated(c) for c in cards) / 2**30
        chk.check(rc == 0, f"filter_mrc {args} {' '.join(extra)} exit {rc}")
        print(f"  {label}: wall {wall:.3f} s for read + filter + write; "
              f"stages: " + ", ".join(f"{k} {v:.3f} s"
                                      for k, v in rep.timings.items())
              + f"; peak device memory {peak:.2f} GiB on one card; "
              f"{rep.format_paths()}; launches {counts} [{card}]")
        outs[label] = (mrc.read_mrc(fout).data, rep.paths)
        launches[label] = counts
        if label == "-mesh":
            kept = fout
        else:
            os.unlink(fout)
    (meshed, paths), (single, paths1) = outs["-mesh"], outs["single device"]
    n = len(mesh_devs)
    lm = launches["-mesh"]
    chk.check(lm["hessian_principal_block"] == n
              and lm["tv_votes_prepadded"] == n and lm["sym3_score"] == n
              and lm["blur3"] == n and lm["hessian_principal"] == 0
              and lm["tv_votes"] == 0,
              f"-mesh run: each per-shard kernel launched once per block "
              f"({n}), no single-device Hessian or voting launch: {lm}")
    l1 = launches["single device"]
    chk.check(all(l1[k] > 0 for k in ("blur3", "hessian_principal",
                                       "tv_votes", "sym3_score")),
              f"single-device run launched its kernels: {l1}")
    chk.check(paths.get("tv") == "cuda-sharded-sparse"
              and paths.get("hessian_eigen") == "cuda-sharded"
              and paths1.get("tv") == "cuda-sparse",
              f"paths: -mesh {paths}, single device {paths1}")
    nd = int((meshed.view(np.int32) != single.view(np.int32)).sum())
    chk.check(meshed.shape == shape and nd == 0,
              f"-mesh output == single-device output: {nd} voxels differ")
    chk.check(bool(np.isfinite(meshed).all()), "-mesh output finite")
    share = _membrane_metrics(torch.tensor(meshed, device=dev), dist, 3.0)
    chk.check(share >= 0.9, f"top 0.5% voxels within 3 voxels of a phantom "
                            f"membrane: {share:.4f}")
    return lm, (fin, kept)

# ---------------------------------------------------------------------------
# phase 6: -connect

CONNECT_ARGS = "-w 1 -membrane minima 3 -tv 1.5 -tv-angle-exponent 4"
CONNECT_QUANTILE = 0.96         # the -connect threshold's score quantile
NORMALS_SHAPE = (48, 96, 96)    # (Z, Y, X) of the -normals-file run
GATE_CROP = (64, 256, 256)      # (Z, Y, X) of 6a's gate comparison
FLOOD_CROP = 64                 # side of 6a's native-vs-Python crop


class _PeakRss:
    """The host's peak resident memory of this process while the block
    runs: ``/proc/self/statm`` sampled every 10 ms by a thread (the
    machine's kernel keeps no resettable high-water mark)."""

    def __enter__(self):
        import threading
        self.peak, self.done = 0, threading.Event()
        page = os.sysconf("SC_PAGE_SIZE")

        def sample():
            while True:
                with open("/proc/self/statm") as f:
                    self.peak = max(self.peak, int(f.read().split()[1]) * page)
                if self.done.wait(0.01):
                    return
        self.thread = threading.Thread(target=sample, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.done.set()
        self.thread.join()

    @property
    def gib(self) -> float:
        return self.peak / 2**30


class _ConnectCapture:
    """Records the CLI's ``label_connected`` call (arguments and result)
    and the ``want_v`` of each ``sym3_score`` call, one device or per
    block, by standing in for them in ``cli.filter_mrc`` and
    ``parallel.sharded``; no kernel output is held."""

    def __enter__(self):
        from visfd_tpu_torch.cli import filter_mrc as TFM
        from visfd_tpu_torch.parallel import sharded as SH
        self.calls, self.want_v = [], []
        self.slots = [(TFM, "label_connected"), (TFM, "sym3_score"),
                      (SH, "sym3_score")]
        self.saved = [getattr(m, n) for m, n in self.slots]
        connect, score, _ = self.saved

        def wrapped_connect(*args, **kwargs):
            out = connect(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out

        def wrapped_score(*args, **kwargs):
            self.want_v.append(kwargs.get("want_v", len(args) > 3
                                          and args[3]))
            return score(*args, **kwargs)
        for (m, n), fn in zip(self.slots, (wrapped_connect, wrapped_score,
                                           wrapped_score)):
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.slots, self.saved):
            setattr(m, n, fn)


def _connect_threshold(chk, card, tmp, shape, dev):
    """The -connect threshold: the CONNECT_QUANTILE of the stick score
    that ``CONNECT_ARGS`` writes for the phantom of 6c's first run."""
    import torch
    from visfd_tpu_torch.cli import filter_mrc as TFM
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.utils.phantom import membrane_phantom
    from visfd_tpu_torch.utils.progress import Report
    vol, _ = membrane_phantom(shape, seed=SEED + 60, thickness=3.0,
                              device=dev)
    fin, fout = os.path.join(tmp, "c_in.mrc"), os.path.join(tmp, "c_s.mrc")
    mrc.write_mrc(fin, vol.cpu().numpy())
    del vol
    rc = TFM.run(["-in", fin, "-out", fout] + CONNECT_ARGS.split(),
                 device=dev, report=Report(None))
    score = torch.tensor(mrc.read_mrc(fout).data, device=dev)
    os.unlink(fout)
    thr = float(torch.quantile(score.reshape(-1)[::7], CONNECT_QUANTILE))
    chk.check(rc == 0 and thr > 0, f"the -connect threshold T = {thr!r}, the "
              f"{CONNECT_QUANTILE} quantile of the stick score of "
              f"{'x'.join(map(str, shape[::-1]))} [{card}]")
    return thr, fin


def phase_connect_runs(chk, card, tmp, shapes=(MAIN_SHAPE,), dev="cuda"):
    """6c: the -connect CLI at each shape.  Returns (T, the first run's
    launch counts, its captured label_connected call)."""
    import torch
    from visfd_tpu_torch.cli import filter_mrc as TFM
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.ops import blur_cuda, eigen_cuda as EC
    from visfd_tpu_torch.ops import tv_cuda
    from visfd_tpu_torch.utils.phantom import membrane_phantom
    from visfd_tpu_torch.utils.progress import Report

    print(f"== phase 6c: filter_mrc {CONNECT_ARGS} -connect T -connect-angle "
          f"30 [{card}]", flush=True)
    thr, fin0 = _connect_threshold(chk, card, tmp, shapes[0], dev)
    wrappers = {"blur3": blur_cuda.blur3,
                "hessian_principal": EC.hessian_principal,
                "tv_votes": tv_cuda.tv_votes,
                "sym3_score": EC.sym3_score}
    spans = ("connect: gates", "connect: seeds",
             "connect: candidate mask + compaction", "connect: candidate copy",
             "connect: native flood", "connect: finalize",
             "write the tomogram")
    first = None
    for i, shape in enumerate(shapes):
        vol, dist = membrane_phantom(shape, seed=SEED + 60 + i,
                                     thickness=3.0, device=dev)
        fin = fin0 if i == 0 else os.path.join(tmp, "c_in1.mrc")
        if i:
            mrc.write_mrc(fin, vol.cpu().numpy())
        del vol
        fout = os.path.join(tmp, "c_out.mrc")
        argv = (["-in", fin, "-out", fout] + CONNECT_ARGS.split()
                + ["-connect", repr(thr), "-connect-angle", "30"])
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        rep = Report(None)
        with _ConnectCapture() as ccap, _PeakRss() as rss:
            t0 = time.perf_counter()
            rc = TFM.run(argv, device=dev, report=rep)
            wall = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        label = f"{'x'.join(map(str, shape[::-1]))} (X x Y x Z)"
        chk.check(rc == 0, f"{label} -connect {thr!r} exit {rc}")
        chk.check(all(c > 0 for c in counts.values())
                  and counts["sym3_score"] == 1,
                  f"{label} launch counts in the -connect run (the vote "
                  f"score once): {counts}")
        chk.check(ccap.want_v == [True] * counts["sym3_score"],
                  f"{label} sym3_score launched with the vector: "
                  f"{ccap.want_v}")
        res = ccap.calls[0][2] if ccap.calls else None
        out = torch.tensor(mrc.read_mrc(fout).data, device=dev)
        n_cl = res.num_clusters if res is not None else -1
        chk.check(tuple(out.shape) == shape and bool(out.isfinite().all())
                  and n_cl > 0 and float(out.max()) == n_cl + 1,
                  f"{label} labels {tuple(out.shape)}, finite, clusters 1.."
                  f"{n_cl}, the rest {n_cl + 1}")
        top = (out >= 1) & (out <= min(10, n_cl))
        share = float((dist[top] <= 2.0).float().mean())
        sizes = [int(v) for v in res.cluster_sizes[:10]] if res else []
        chk.check(share >= 0.8, f"{label} share of the 10 largest clusters' "
                                f"voxels ({sizes}) within 2 voxels of a "
                                f"phantom mid-surface: {share:.4f}")
        print(f"  {label}: wall {wall:.3f} s; spans: "
              + ", ".join(f"{k} {rep.timings.get(k, float('nan')):.3f} s"
                          for k in spans)
              + f"; other stages: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in rep.timings.items()
                          if k not in spans)
              + f"; counts {rep.counts}; peak card memory {peak:.2f} GiB; "
              f"host peak RSS {rss.gib:.2f} GiB; {rep.format_paths()}; "
              f"launches {counts} [{card}]",
              flush=True)
        if i == 0:
            first = (counts, ccap.calls[0] if ccap.calls else None)
        del out, dist, top, ccap, res
        os.unlink(fout)
        os.unlink(fin)
        torch.cuda.empty_cache()
    return thr, first[0], first[1]


def phase_connect_host(chk, card, captured, thr, dev="cuda"):
    """6a: the 6c run's own score, vote and vector: card against the
    host."""
    import torch
    from visfd_tpu_torch.features.hessian import hessian_fd
    from visfd_tpu_torch.linalg import sym3
    from visfd_tpu_torch.segment import connect as TC
    from visfd_tpu_torch.segment import extrema as TE

    args, kw, _ = captured
    score, vote, vec = args[0], kw["tensor"], kw["vector"]
    print(f"== phase 6a: -connect on the card against the host, "
          f"{tuple(score.shape)} [{card}]", flush=True)
    seed_kw = dict(connectivity=1, find_minima=False, find_maxima=True,
                   maxima_threshold=thr, want_label_image=False)
    t0 = time.perf_counter()
    got = TE.find_extrema(score, **seed_kw)
    t_card = time.perf_counter() - t0
    score_h = score.cpu()
    t0 = time.perf_counter()
    want = TE.find_extrema(score_h, **seed_kw)
    t_host = time.perf_counter() - t0
    chk.check(np.array_equal(got.maxima_indices, want.maxima_indices)
              and np.array_equal(got.maxima_scores, want.maxima_scores),
              f"find_extrema seeds card == CPU: {len(got.maxima_indices)} "
              f"seeds ({t_card:.3f} s on the card, {t_host:.3f} s on the "
              f"CPU)")

    # the gates on a crop: equal wherever both sides of each gate differ
    # by more than 1e-5 of the larger and the principal eigenvalue of the
    # saliency's Hessian is separated from the next by 1e-3 of the
    # largest (else the eigenvector the vector gate reads is ill-defined
    # and an ulp turns it)
    cos30 = float(np.cos(30 * np.pi / 180.0))
    order = sym3.EigenOrder.DECREASING
    z0 = max(0, int(0.3 * score.shape[0]) - GATE_CROP[0] // 2)
    crop = (slice(z0, z0 + GATE_CROP[0]), slice(0, GATE_CROP[1]),
            slice(0, GATE_CROP[2]))
    s_c, t_c, v_c = (score[crop], vote[(slice(None),) + crop],
                     vec[(slice(None),) + crop])
    gate_args = (cos30, cos30, order, False, True)
    d_card = TC.discard_gates(s_c, t_c, v_c, *gate_args).cpu()
    s_h, t_h, v_h = (t.cpu() for t in (s_c, t_c, v_c))
    d_host = TC.discard_gates(s_h, t_h, v_h, *gate_args)
    hess = -hessian_fd(s_h)
    near = torch.zeros_like(d_host)
    for lhs, rhs in TC.gate_sides(hess, t_h.movedim(0, -1),
                                  v_h.movedim(0, -1), cos30, cos30, order,
                                  False):
        big = torch.maximum(lhs.double().abs(), rhs.double().abs())
        near |= ((lhs.double() - rhs.double()).abs() <= 1e-5 * big) & (big > 0)
    vals, _ = sym3.principal_sym3(sym3.flat_to_full(hess), order=order)
    ill = (vals[..., 0] - vals[..., 1]).abs() <= 1e-3 * vals.abs().amax(-1)
    differ = d_card != d_host
    out = differ & ~near & ~ill
    chk.check(not bool(out.any()),
              f"discard gates card == CPU on a {GATE_CROP} crop: "
              f"{int(d_host.sum())} of {d_host.numel()} voxels discarded; "
              f"{int(differ.sum())} differ, {int((differ & near).sum())} of "
              f"them within 1e-5 of a gate ({int(near.sum())} such voxels) "
              f"and {int((differ & ill & ~near).sum())} more with a Hessian "
              f"eigen gap below 1e-3 ({int(ill.sum())} such voxels), "
              f"{int(out.sum())} outside both")
    del d_card, d_host, near, ill, differ, out, hess, vals, t_h, v_h

    # the candidate lists, card against CPU, the card's gates on both
    discard = TC.discard_gates(score, vote, vec, *gate_args)
    parts = TC.compact_candidates(score, discard, None, vote, vec, thr, -1.0)
    host = TC.compact_candidates(score_h, discard.cpu(), None, vote.cpu(),
                                 vec.cpu(), thr, -1.0)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(parts, host))
    chk.check(same, f"candidate lists card == CPU: {len(host[0])} candidates "
                    f"({len(host[0]) / score.numel():.4f} of the voxels), "
                    f"{int(host[2].sum())} of them discarded")
    del parts, host, discard

    # the native flood against its Python twin on a crop
    n = FLOOD_CROP
    z0 = max(0, int(0.3 * score.shape[0]) - n // 2)
    crop = (slice(z0, z0 + n), slice(0, n), slice(0, n))
    s_c = score_h[crop].contiguous()
    t_c = vote[(slice(None),) + crop].cpu()
    v_c = vec[(slice(None),) + crop].cpu()
    disc = TC.discard_gates(s_c, t_c, v_c, *gate_args).numpy()
    res = TE.find_extrema(s_c, **seed_kw)
    seeds = np.stack(TE.flat_to_xyz(res.maxima_indices, s_c.shape), -1)
    t_cl = np.ascontiguousarray(t_c.movedim(0, -1).numpy())
    v_cl = np.ascontiguousarray(v_c.movedim(0, -1).numpy())
    fl_args = (s_c.numpy(), None, disc, seeds, res.maxima_scores,
               len(seeds), TE.neighbor_offsets(1), -1.0, thr, t_cl, v_cl,
               cos30, cos30, False)
    t0 = time.perf_counter()
    nat = TC._flood_native(*fl_args, v_cl.copy())
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = TC._flood_python(*fl_args, v_cl.copy())
    t_py = time.perf_counter() - t0
    same = (np.array_equal(nat[0], py[0]) and np.array_equal(nat[1], py[1])
            and np.array_equal(nat[3], py[3]) and np.array_equal(nat[4], py[4])
            and nat[5] == py[5])
    chk.check(same, f"native flood == Python twin on a {n}^3 crop: "
                    f"{len(seeds)} basins, {int((nat[0] < len(seeds)).sum())} "
                    f"voxels assigned ({t_nat:.3f} s native, {t_py:.3f} s "
                    f"Python)")


def phase_connect_goldens(chk, card, tmp, dev="cuda"):
    """6b: the C++ reference's goldens through the CLI on the card, bit
    for bit (PLYs to the JAX golden tests' tolerances)."""
    from visfd_tpu_torch.cli import filter_mrc as TFM
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.io.pointcloud import read_ply_pointcloud
    from visfd_tpu_torch.utils.progress import Report

    print(f"== phase 6b: the C++ reference's -connect goldens on the card "
          f"[{card}]", flush=True)
    g = os.path.join(ROOT, "tests", "golden")
    zero = os.path.join(tmp, "zero.mrc")
    mrc.write_mrc(zero, np.zeros((16, 16, 16), np.float32))
    out, ply = os.path.join(tmp, "g.mrc"), os.path.join(tmp, "g.ply")
    common = (f"-w 19.2 -in {zero} -out {out} -membrane minima 55 -tv 4 "
              f"-tv-angle-exponent 4 -bin 2 -load-progress {g}/ref_prog")
    cases = [
        ("-connect 1e+09 -connect-angle 30 -normals-file {ply} "
         "-select-cluster 1", "ref_memb_conn.mrc", "ref_memb.ply"),
        ("-connect 5e+09 -connect-angle 10", "ref_memb_frag.mrc", None),
        ("-connect 5e+09 -connect-angle 10 -must-link {g}/ref_ml.txt "
         "-select-cluster 1 -normals-file {ply}", "ref_memb_ml.mrc",
         "ref_memb_ml.ply"),
        (None, "ref_conn.mrc", None),
    ]
    for extra, ref, ref_ply in cases:
        argv = (f"-in {g}/ref_gauss.mrc -out {out} -w 1 -connect 37"
                if extra is None else
                common + " " + extra.format(ply=ply, g=g)).split()
        rc = TFM.run(argv, device=dev, report=Report(None))
        got, want = mrc.read_mrc(out).data, mrc.read_mrc(
            os.path.join(g, ref)).data
        nd = int((got != want).sum()) if got.shape == want.shape else -1
        msg = f"{ref}: {nd} voxels differ"
        ok = rc == 0 and nd == 0
        if ref_ply:
            (c, nrm), (c_r, n_r) = (read_ply_pointcloud(ply),
                                    read_ply_pointcloud(
                                        os.path.join(g, ref_ply)))
            ok_p = c.shape == c_r.shape and bool(
                np.allclose(c, c_r, rtol=1e-7, atol=1e-3) and np.allclose(
                    nrm, n_r, rtol=1e-7, atol=1e-4 * np.abs(n_r).max()))
            ok = ok and ok_p
            msg += (f"; {ref_ply}: {len(c)} vertices ({len(c_r)} in the "
                    f"golden), within tolerance: {ok_p}")
        chk.check(ok, msg)


def phase_edge_card_vs_cpu(chk, card, tmp, shape=(48, 64, 80), dev="cuda"):
    """6b, continued: ``-edge … -tv`` (the gradient branch on a 1 x 1
    grid of blocks, then ``ops/tv_cuda.tv_votes``) on the card against
    the CPU, to the TV tolerance."""
    import torch
    from visfd_tpu_torch.cli import filter_mrc as TFM
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.utils.phantom import membrane_phantom
    from visfd_tpu_torch.utils.progress import Report

    print(f"== phase 6b: -edge on the card against the CPU, (Z, Y, X) = "
          f"{shape} [{card}]", flush=True)
    vol, _ = membrane_phantom(shape, seed=SEED + 63, thickness=3.0)
    fin = os.path.join(tmp, "e_in.mrc")
    mrc.write_mrc(fin, vol.numpy())
    outs = {}
    for d in (dev, "cpu"):
        fout = os.path.join(tmp, f"e_{d}.mrc")
        TFM.run(["-in", fin, "-out", fout] + "-w 1 -edge minima 1.5 -tv 1.5 "
                "-tv-best 1.0".split(), device=d, report=Report(None))
        outs[d] = torch.tensor(mrc.read_mrc(fout).data)
    ok, err, atol = close(outs[dev], outs["cpu"], 2e-4, 2e-5)
    chk.check(ok and bool(outs[dev].isfinite().all()),
              f"-edge card == CPU to rtol 2e-4, atol 2e-5 x max: "
              f"max|d|={err:.3g} (atol {atol:.3g})")


def phase_connect_normals(chk, card, tmp, thr, shape=NORMALS_SHAPE,
                          dev="cuda"):
    """6c, continued: -select-cluster 1 -normals-file on a small phantom;
    the walker's seconds per PLY vertex."""
    from visfd_tpu_torch.cli import filter_mrc as TFM
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.io.pointcloud import read_ply_pointcloud
    from visfd_tpu_torch.utils.phantom import membrane_phantom
    from visfd_tpu_torch.utils.progress import Report

    label = f"{'x'.join(map(str, shape[::-1]))} (X x Y x Z)"
    print(f"== phase 6c: -select-cluster 1 -normals-file, {label} [{card}]",
          flush=True)
    vol, _ = membrane_phantom(shape, seed=SEED + 62, thickness=3.0)
    fin, fout = os.path.join(tmp, "n_in.mrc"), os.path.join(tmp, "n_out.mrc")
    ply = os.path.join(tmp, "n.ply")
    mrc.write_mrc(fin, vol.numpy())
    rep = Report(None)
    rc = TFM.run(["-in", fin, "-out", fout] + CONNECT_ARGS.split()
                 + ["-connect", repr(thr), "-connect-angle", "30",
                    "-select-cluster", "1", "-normals-file", ply],
                 device=dev, report=rep)
    c, nrm = read_ply_pointcloud(ply)
    t = rep.timings.get("-normals-file", float("nan"))
    chk.check(rc == 0 and len(c) > 0 and bool(np.isfinite(c).all()
                                              and np.isfinite(nrm).all()),
              f"{label} -normals-file: {len(c)} vertices, finite")
    print(f"  walker {t:.3f} s for {len(c)} vertices: "
          f"{t / max(len(c), 1) * 1e3:.3f} ms per vertex (host) [{card}]")
    for f in (fin, fout, ply):
        os.unlink(f)


# ---------------------------------------------------------------------------
# phase 7: the segmentation handlers and the intensity map

SEG_SHAPE = MESH_SHAPE          # (Z, Y, X) of 7a, 7c and the 7d timing
SEG_CROP = (128, 256, 256)      # 7a's card-against-CPU crop
# 7b's shape: the native flood takes 2.5-3.6 us a voxel (245 s at
# 256 x 512 x 512, 84.6 s at 128 x 512 x 512 on an H100 80GB HBM3 at
# 700 W), so a quarter of that depth leaves phases 8-10 their room in
# the 1200 s
WS_SHAPE = (64, 512, 512)
PY_CROP = 48                    # 7b's native-against-Python crop
PROP_CROP = (64, 128, 128)      # 7c's card-against-CPU crop
DISTINCT_CROP = (24, 48, 48)    # 7c's crop against the host Meyer flood
M7_SMALL = (32, 64, 64)         # 7d's -normals-file and boundary cases
SEG_BLUR = 3.0                  # the phantoms' blur (sigma, voxels)


def _seg_phantom(shape, seed, dev):
    """A seeded membrane phantom blurred at SEG_BLUR, on the host."""
    from visfd_tpu_torch.ops.filters import apply_gauss
    from visfd_tpu_torch.utils.phantom import membrane_phantom
    vol, _ = membrane_phantom(shape, seed=seed, thickness=3.0, device=dev)
    return apply_gauss(vol, SEG_BLUR).cpu().numpy()


def _run_cli(argv, dev, mesh=None, **kw):
    """(exit code, wall s, Report) of one CLI run; ``mesh``: -mesh blocks
    on these devices."""
    from visfd_tpu_torch.cli import filter_mrc as TFM
    from visfd_tpu_torch.utils.progress import Report
    rep = Report(None)
    t0 = time.perf_counter()
    rc = TFM.run(argv, device=dev, report=rep, mesh_devices=mesh, **kw)
    return rc, time.perf_counter() - t0, rep


def _spans(rep):
    return ", ".join(f"{k} {v:.3f} s" for k, v in rep.timings.items())


def _same_files(chk, label, a, b):
    """Two MRC outputs (and text files, when given as pairs) equal."""
    from visfd_tpu_torch.io import mrc
    x, y = mrc.read_mrc(a).data, mrc.read_mrc(b).data
    nd = int((x.view(np.int32) != y.view(np.int32)).sum()) \
        if x.shape == y.shape else -1
    return chk.check(nd == 0, f"{label}: {nd} voxels differ")


def phase_extrema(chk, card, tmp, dev="cuda"):
    """7a: -find-minima and -find-maxima at SEG_SHAPE; the card against
    the CPU on a crop.  Returns the input file (7c reads it too)."""
    import torch
    from visfd_tpu_torch.io import mrc

    label = f"{'x'.join(map(str, SEG_SHAPE[::-1]))} (X x Y x Z)"
    print(f"== phase 7a: -find-minima / -find-maxima, {label}, a phantom "
          f"blurred at sigma {SEG_BLUR} [{card}]", flush=True)
    vol = _seg_phantom(SEG_SHAPE, SEED + 70, dev)
    fin = os.path.join(tmp, "seg_in.mrc")
    mrc.write_mrc(fin, vol)
    z0 = SEG_SHAPE[0] // 3
    crop = np.ascontiguousarray(vol[z0:z0 + SEG_CROP[0], :SEG_CROP[1],
                                    :SEG_CROP[2]])
    del vol
    fcrop = os.path.join(tmp, "seg_crop.mrc")
    mrc.write_mrc(fcrop, crop)
    fout = os.path.join(tmp, "seg_out.mrc")
    for kind in ("minima", "maxima"):
        txt = os.path.join(tmp, f"{kind}.txt")
        torch.cuda.reset_peak_memory_stats()
        with _PeakRss() as rss:
            rc, wall, rep = _run_cli(["-in", fin, "-out", fout, "-w", "1",
                                      f"-find-{kind}", txt], dev)
        n = sum(1 for _ in open(txt)) if os.path.exists(txt) else 0
        out = mrc.read_mrc(fout).data
        chk.check(rc == 0 and n > 0 and out.shape == SEG_SHAPE
                  and float(out.max()) == n,
                  f"{label} -find-{kind}: {n} {kind}, label image "
                  f"1..{float(out.max()):.0f}")
        print(f"  -find-{kind}: wall {wall:.3f} s; {_spans(rep)}; peak card "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB;"
              f" host peak RSS {rss.gib:.2f} GiB [{card}]", flush=True)
        del out
        os.unlink(txt)
        outs = []
        for d in (dev, "cpu"):
            t = os.path.join(tmp, f"c_{kind}_{d}.txt")
            o = os.path.join(tmp, f"c_{kind}_{d}.mrc")
            _run_cli(["-in", fcrop, "-out", o, "-w", "1", f"-find-{kind}",
                      t], d)
            outs.append((o, open(t).read()))
        same = outs[0][1] == outs[1][1]
        _same_files(chk, f"-find-{kind} on a {SEG_CROP} crop, card == CPU "
                         f"({len(outs[1][1].splitlines())} {kind}, text "
                         f"files equal: {same})", outs[0][0], outs[1][0])
        chk.check(same, f"-find-{kind} text files card == CPU")
    os.unlink(fout)
    return fin


def phase_watershed_host(chk, card, tmp, dev="cuda"):
    """7b: -watershed minima (the host Meyer flood, seeds on the card)."""
    import torch
    from visfd_tpu_torch.segment import extrema as TE
    from visfd_tpu_torch.segment import watershed as TW

    shape = WS_SHAPE
    label = f"{'x'.join(map(str, shape[::-1]))} (X x Y x Z)"
    print(f"== phase 7b: -watershed minima (native flood), {label} "
          f"[{card}]", flush=True)
    from visfd_tpu_torch.io import mrc
    vol = _seg_phantom(shape, SEED + 71, dev)
    fin, fout = os.path.join(tmp, "ws_in.mrc"), os.path.join(tmp, "ws.mrc")
    mrc.write_mrc(fin, vol)
    with _PeakRss() as rss:
        rc, wall, rep = _run_cli(["-in", fin, "-out", fout, "-w", "1",
                                  "-watershed", "minima"], dev)
    out = mrc.read_mrc(fout).data
    n = rep.counts.get("watershed basins", -1)
    chk.check(rc == 0 and n > 0 and float(out.max()) == n,
              f"{label} -watershed minima: {n} basins, labels up to "
              f"{float(out.max()):.0f}, boundaries "
              f"{float((out == 0).mean()):.4f} of the voxels")
    flood = rep.timings.get("watershed: native flood", float("nan"))
    print(f"  wall {wall:.3f} s; {_spans(rep)}; native flood "
          f"{flood / vol.size * 1e6:.4f} us per voxel; host peak RSS "
          f"{rss.gib:.2f} GiB [{card}]", flush=True)
    del out
    os.unlink(fin)
    os.unlink(fout)

    # the native flood against its Python twin on a crop
    c = np.ascontiguousarray(vol[:PY_CROP, :PY_CROP, :PY_CROP])
    del vol
    res = TE.find_extrema(torch.tensor(c, device=dev), find_maxima=False,
                          connectivity=3, want_label_image=False)
    locs = [TE.flat_to_xyz(int(i), c.shape) for i in res.minima_indices]
    t0 = time.perf_counter()
    nat = TW.watershed(torch.tensor(c, device=dev), connectivity=3).labels
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = TW._flood_python(c, None, locs, res.minima_scores, len(locs),
                          TE.neighbor_offsets(3), 1.0, np.inf, True)
    t_py = time.perf_counter() - t0
    chk.check(np.array_equal(nat, py),
              f"native flood == Python twin on a {c.shape} crop: "
              f"{len(locs)} basins ({t_nat:.3f} s native with the seeds on "
              f"the card, {t_py:.3f} s Python)")

    # ref_gauss.mrc, with and without markers: the card against the CPU
    g = os.path.join(ROOT, "tests", "golden")
    for extra in ([], ["-markers", os.path.join(g, "ref_markers.mrc"),
                       "-watershed-show-boundaries"]):
        outs = []
        for d in (dev, "cpu"):
            o = os.path.join(tmp, f"g_ws_{d}.mrc")
            _run_cli(["-in", os.path.join(g, "ref_gauss.mrc"), "-out", o,
                      "-w", "1", "-watershed", "minima"] + extra, d)
            outs.append(o)
        _same_files(chk, f"ref_gauss.mrc -watershed minima {' '.join(extra)}"
                         f" card == CPU", *outs)


def phase_watershed_device(chk, card, tmp, fin, dev="cuda"):
    """7c: -watershed-device at SEG_SHAPE on one card; crops against the
    CPU and against the host Meyer flood."""
    import torch
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.segment import propagate as TP
    from visfd_tpu_torch.segment import watershed as TW

    label = f"{'x'.join(map(str, SEG_SHAPE[::-1]))} (X x Y x Z)"
    args = ["-w", "1", "-watershed", "minima", "-watershed-device",
            "-watershed-hide-boundaries"]
    print(f"== phase 7c: {' '.join(args)}, {label}, one card [{card}]",
          flush=True)
    fout = os.path.join(tmp, "wsd.mrc")
    torch.cuda.reset_peak_memory_stats()
    with _PeakRss() as rss:
        rc, wall, rep = _run_cli(["-in", fin, "-out", fout] + args, dev)
    out = mrc.read_mrc(fout).data
    n = rep.counts.get("watershed basins", -1)
    chk.check(rc == 0 and n > 0 and float(out.max()) == n
              and float(out.min()) >= 1,
              f"{label} -watershed-device: {n} basins, every voxel in one")
    rounds = {k: v for k, v in rep.counts.items() if "rounds" in k}
    print(f"  wall {wall:.3f} s; {_spans(rep)}; loop iterations {rounds}; "
          f"peak card memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; host peak RSS {rss.gib:.2f} GiB [{card}]", flush=True)
    vol = mrc.read_mrc(fin).data
    del out
    os.unlink(fout)

    z0 = SEG_SHAPE[0] // 2
    c = np.ascontiguousarray(vol[z0:z0 + PROP_CROP[0], :PROP_CROP[1],
                                 :PROP_CROP[2]])
    d = np.ascontiguousarray(vol[:DISTINCT_CROP[0], :DISTINCT_CROP[1],
                                 :DISTINCT_CROP[2]])
    del vol
    for conn in (1, 3):
        t0 = time.perf_counter()
        got = TP.propagate_watershed(torch.tensor(c, device=dev),
                                     connectivity=conn)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = TP.propagate_watershed(c, connectivity=conn)
        t_cpu = time.perf_counter() - t0
        chk.check(torch.equal(got.labels.cpu(), want.labels),
                  f"propagate_watershed connectivity {conn} on a {PROP_CROP} "
                  f"crop, card == CPU: {want.num_basins} basins ({t_card:.3f}"
                  f" s card, {t_cpu:.3f} s CPU)")
    # distinct intensities (their ranks): the device watershed gives the
    # host Meyer flood's labels, boundaries included
    ranks = np.empty(d.size, np.float32)
    ranks[np.argsort(d, axis=None, kind="stable")] = np.arange(d.size)
    d = ranks.reshape(d.shape)
    for sb in (False, True):
        host = TW.watershed(d, show_boundaries=sb)
        dev_ = TP.propagate_watershed(torch.tensor(d, device=dev),
                                      show_boundaries=sb)
        chk.check(np.array_equal(dev_.labels.cpu().numpy(), host.labels),
                  f"device watershed == host Meyer flood on a "
                  f"{DISTINCT_CROP} crop of distinct values, boundaries "
                  f"{sb}: {host.num_basins} basins")


def phase_mesh_segment(chk, card, tmp, thr, dev="cuda"):
    """7d: -mesh 4 on the card against one device, bit for bit: the
    device watershed, -edge and -normals-file at MAIN_SHAPE or M7_SMALL,
    then -connect at SEG_SHAPE with its spans, card memory and host RSS
    (the single-device run is 6c's at this size).  Returns the
    sym3_score launches of the -connect -mesh run."""
    import torch
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.io.pointcloud import read_ply_pointcloud
    from visfd_tpu_torch.ops import blur_cuda, eigen_cuda as EC
    from visfd_tpu_torch.ops import tv_cuda
    from visfd_tpu_torch.utils.phantom import membrane_phantom

    mesh_devs = [d for row in _mesh().devices for d in row]
    print(f"== phase 7d: -mesh {MESH_DEVICES} (blocks on "
          f"{[str(d) for d in mesh_devs]}) against one device [{card}]",
          flush=True)
    files = {}
    for name, shape, blurred in (("ws", MAIN_SHAPE, True),
                                 ("ws_small", M7_SMALL, True),
                                 ("memb", MAIN_SHAPE, False),
                                 ("small", M7_SMALL, False)):
        files[name] = os.path.join(tmp, f"m7_{name}.mrc")
        vol = (_seg_phantom(shape, SEED + 73, dev) if blurred else
               membrane_phantom(shape, seed=SEED + 72, thickness=3.0,
                                device=dev)[0].cpu().numpy())
        mrc.write_mrc(files[name], vol)
    conn = CONNECT_ARGS.split() + ["-connect", repr(thr), "-connect-angle",
                                   "30"]
    cases = [
        ("ws", "-w 1 -watershed minima -watershed-device "
               "-watershed-hide-boundaries".split(), False),
        ("ws_small", "-w 1 -watershed minima -watershed-device".split(),
         False),
        ("memb", "-w 1 -edge minima 1.5 -tv 1.5 -tv-angle-exponent 4"
         .split(), False),
        ("small", conn + ["-select-cluster", "1", "-normals-file"], True),
    ]
    for name, args, ply in cases:
        outs = []
        for tag, mesh in (("one", None), ("mesh", mesh_devs)):
            o = os.path.join(tmp, f"m7_{tag}.mrc")
            p = os.path.join(tmp, f"m7_{tag}.ply")
            argv = ["-in", files[name], "-out", o] + args + (
                [p] if ply else []) + (["-mesh", str(MESH_DEVICES)]
                                       if mesh else [])
            rc, wall, rep = _run_cli(argv, dev, mesh)
            chk.check(rc == 0, f"{' '.join(argv[4:])} exit {rc}")
            print(f"  {tag}: wall {wall:.3f} s; {_spans(rep)}; "
                  f"{rep.format_paths()} [{card}]", flush=True)
            outs.append((o, p))
        _same_files(chk, f"{' '.join(args[:5])}... on {name} -mesh "
                         f"{MESH_DEVICES} == one device", outs[1][0],
                    outs[0][0])
        if ply:
            a, b = (read_ply_pointcloud(p) for _, p in outs)
            same = all(np.array_equal(x, y) for x, y in zip(a, b))
            chk.check(same and len(a[0]) > 0,
                      f"-normals-file -mesh {MESH_DEVICES} == one device: "
                      f"{len(a[0])} vertices")
    for f in files.values():
        os.unlink(f)

    # -connect at SEG_SHAPE, one device then -mesh 4: equal labels,
    # spans, memory, launches
    label = f"{'x'.join(map(str, SEG_SHAPE[::-1]))} (X x Y x Z)"
    print(f"== phase 7d: filter_mrc {CONNECT_ARGS} -connect T -connect-angle "
          f"30, one device and -mesh {MESH_DEVICES}, {label} [{card}]",
          flush=True)
    vol, dist = membrane_phantom(SEG_SHAPE, seed=SEED + 61, thickness=3.0,
                                 device=dev)
    fin = os.path.join(tmp, "m7_big.mrc")
    mrc.write_mrc(fin, vol.cpu().numpy())
    del vol
    wrappers = {"blur3": blur_cuda.blur3,
                "hessian_principal": EC.hessian_principal,
                "hessian_principal_block": EC.hessian_principal_block,
                "tv_votes": tv_cuda.tv_votes,
                "tv_votes_prepadded": tv_cuda.tv_votes_prepadded,
                "sym3_score": EC.sym3_score}
    outs, counts = {}, {}
    for tag, mesh in (("one device", None), ("-mesh", mesh_devs)):
        fout = os.path.join(tmp, f"m7_big_{len(outs)}.mrc")
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        with _ConnectCapture() as ccap, _PeakRss() as rss:
            rc, wall, rep = _run_cli(
                ["-in", fin, "-out", fout] + conn + (
                    ["-mesh", str(MESH_DEVICES)] if mesh else []), dev, mesh)
        counts[tag] = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        res = ccap.calls[0][2] if ccap.calls else None
        outs[tag] = mrc.read_mrc(fout).data
        os.unlink(fout)
        n_cl = res.num_clusters if res is not None else -1
        chk.check(rc == 0 and n_cl > 0
                  and float(outs[tag].max()) == n_cl + 1
                  and all(ccap.want_v), f"{label} -connect, {tag}: clusters "
                  f"1..{n_cl}, the vote score with its vector "
                  f"({len(ccap.want_v)} calls)")
        print(f"  {tag}: wall {wall:.3f} s; spans: {_spans(rep)}; counts "
              f"{rep.counts}; peak card memory {peak:.2f} GiB; host peak RSS"
              f" {rss.gib:.2f} GiB; {rep.format_paths()}; launches "
              f"{counts[tag]} [{card}]", flush=True)
    os.unlink(fin)
    n_blocks = len(mesh_devs)
    lm = counts["-mesh"]
    chk.check(all(lm[k] == n_blocks for k in ("blur3", "sym3_score",
                                              "hessian_principal_block",
                                              "tv_votes_prepadded"))
              and lm["hessian_principal"] == lm["tv_votes"] == 0,
              f"-connect -mesh: each per-shard kernel launched once per "
              f"block: {lm}")
    one, meshed = outs["one device"], outs["-mesh"]
    nd = int((one != meshed).sum())
    chk.check(nd == 0, f"{label} -connect -mesh {MESH_DEVICES} == one "
                       f"device: {nd} voxels differ")
    top = torch.tensor((meshed >= 1) & (meshed <= min(10, meshed.max() - 1)),
                       device=dist.device)
    share = float((dist[top] <= 2.0).float().mean())
    chk.check(share >= 0.8, f"share of the 10 largest clusters' voxels "
                            f"within 2 voxels of a mid-surface: {share:.4f}")
    del outs, dist, top
    torch.cuda.empty_cache()
    return lm["sym3_score"]


INTENSITY_ARGS = [
    "-thresh2 35 39", "-thresh4 34 36 38 40", "-clip 35 39", "-cl -1 1.5",
    "-thresh-gauss 37 1.5", "-mask-sphere 12 14 10 8 -mask-out 0 "
    "-rescale 2 -70", "-fill 3 -mask-rect 2 20 3 25 1 15 -mask-out -1",
]


def phase_intensity(chk, card, tmp, dev="cuda"):
    """7e: the intensity map, masks and -image-size: card against CPU,
    rtol 1e-6, atol 1e-6 of the largest value."""
    import torch
    from visfd_tpu_torch.io import mrc

    print(f"== phase 7e: -thresh2, -thresh4, -clip, -thresh-gauss, "
          f"-mask-sphere, -image-size: card against CPU [{card}]",
          flush=True)
    g = os.path.join(ROOT, "tests", "golden", "ref_gauss.mrc")
    runs = [["-in", g, "-w", "1"] + a.split() for a in INTENSITY_ARGS]
    runs.append("-image-size 270 220 140 -w 1 -mask-sphere 135 110 70 50 "
                "-mask-sphere-subtract 120 100 70 20 -thresh 0.5 "
                "-mask-out 2".split())
    for argv in runs:
        outs = []
        for d in (dev, "cpu"):
            o = os.path.join(tmp, f"i_{d}.mrc")
            rc, _, _ = _run_cli(argv + ["-out", o], d)
            outs.append(torch.tensor(mrc.read_mrc(o).data))
        ok, err, _ = close(outs[0], outs[1], 1e-6, 1e-6)
        chk.check(rc == 0 and ok and bool((outs[1] != outs[1].reshape(-1)[0])
                                          .any()),
                  f"{' '.join(argv[2 if argv[0] == "-in" else 0:])}: card == "
                  f"CPU, max|d|={err:.3g}")


# ---------------------------------------------------------------------------
# phase 8: the convolution filters and blob detection

BLOB_SHAPE = MESH_SHAPE         # (Z, Y, X) of 8b, 8d and 8f
BLOB_W = 19.6                   # -w: the reference's blob pipeline
BLOB_LADDER = "160 280 1.01"    # ... and its ladder (diameters, physical)
BLOB_COUNT = 1500               # 8b's spheres: one per 179k voxels, the
#                                 density 8b's found-share check was set at
BLOB_CROP = (64, 128, 128)      # 8c's card-against-CPU crop
FILTER_SHAPE = MAIN_SHAPE       # 8e
FILTER_CROP = (32, 64, 64)      # 8e's card-against-CPU crop
AXIS_SHAPE = (64, 512, 512)     # 8a: the per-axis mode
AXIS_HWS = (60, 80)
LADDER_HWS = (6, 7, 8, 9, 10, 11)  # the ladder's LoG halfwidths
# 8e: the filters at -w 1; -gauss 21 takes halfwidth 55 (no fused tile
# holds it: the per-axis mode), -ggauss / -dogg the dense kernel
FILTER_ARGS = ("-gauss 21", "-ggauss 2", "-dog 2 4", "-dogg 2 4", "-log 2",
               "-fluct 3", "-median 2", "-erode 2", "-open 2")
FILTER_EXACT = ("-median", "-erode", "-open")
# the times of the designs the dense kernel (one output a thread) and
# the per-axis blur mode (a tap load beside every FMA) had before their
# redesign, on an H100 80GB HBM3 at 700 W (chip_smoke.py's own phases
# 8a and 9a then), printed beside this run's; None: not timed then
# the fused blur at the ladder's halfwidths 6-10 before its wide
# instance (8a at 268M: the compiled instances 6-8, the runtime one 9-10)
BEFORE_MS = {"blur3_axis hw 55": None, "blur3_axis hw 60": 2.698,
             "blur3_axis hw 80": 3.599, "blur3 hw 6": 3.628,
             "blur3 hw 7": 4.109, "blur3 hw 8": 4.690, "blur3 hw 9": 12.770,
             "blur3 hw 10": 15.627, "conv3d_dense 7^3": 14.482,
             "conv3d_dense 15^3": 103.263,
             "conv3d_dense (1, 21, 21)": 96.222,
             "conv3d_dense 31^3": 48.054}
KERNELS.update({
    # the per-axis mode of csrc/blur.cu (halfwidths above the fused tile;
    # the JAX package sends those to XLA's conv1d, visfd_tpu/ops/conv.py:96)
    "blur3_axis": ("visfd_tpu_torch/csrc/blur.cu",
                   "visfd_tpu/ops/blur_pallas.py:51"),
    # the dense correlation (the JAX package's is XLA's conv, no Pallas)
    "conv3d_dense": ("visfd_tpu_torch/csrc/conv3d.cu",
                     "visfd_tpu/ops/conv.py:164"),
    # the blob ladder's extremum test (the JAX package's is XLA's
    # elementwise minima and maxima, no Pallas)
    "blob_extremum": ("visfd_tpu_torch/csrc/blob_extremum.cu",
                      "visfd_tpu/features/blob.py:70"),
})


def _gauss_taps(hw, dev):
    import torch
    from visfd_tpu_torch.ops import kernels as K
    return [torch.as_tensor(K.gauss_kernel_1d(hw / 2.65, hw), device=dev)
            for _ in range(3)]


def _conv3d_library(x, kflip):
    """The library yardstick of a dense correlation: one cuDNN conv3d
    (it correlates), TF32 off for the call."""
    import torch
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return torch.nn.functional.conv3d(
            x[None, None], kflip[None, None],
            padding=tuple(s // 2 for s in kflip.shape))[0, 0]


def _blur_library(x, ks):
    """The library yardstick of a separable blur: cuDNN conv3d once per
    axis (x, then y, then z; it correlates, so the taps flipped), TF32
    off for the calls."""
    import torch
    w3 = [ks[0].flip(0)[None, None, :], ks[1].flip(0)[None, :, None],
          ks[2].flip(0)[:, None, None]]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        v = x[None, None]
        for w in w3:
            v = torch.nn.functional.conv3d(
                v, w[None, None], padding=tuple(s // 2 for s in w.shape))
        return v[0, 0]


def _speed_line(label, ms, bound, card):
    """``label: kernel t ms, s% of its bound, before: t0 ms``."""
    before = BEFORE_MS.get(label)
    was = "not timed" if before is None else f"{before:.3f} ms"
    print(f"  {label}: {ms:.3f} ms, {100 * bound / ms:.1f}% of its "
          f"{bound:.3f} ms bound; before the redesign {was} [{card}]",
          flush=True)


def _dense_mode(kshape):
    """``7^3`` for a cube, ``(1, 21, 21)`` otherwise."""
    return f"{kshape[0]}^3" if len(set(kshape)) == 1 else str(tuple(kshape))


def phase_filter_kernels(chk, card, dev="cuda"):
    """8a: the per-axis blur mode against its twin at halfwidths 60 and 80
    on AXIS_SHAPE (and against the fused kernel where both run) and at
    8e's -gauss 21 (halfwidth 55) on FILTER_SHAPE, the fused
    kernel at the ladder's halfwidths at BLOB_SHAPE, the dense kernel at
    8e's -ggauss and -dogg kernels on FILTER_SHAPE: checks, CUDA-event
    times, bounds and library calls; each per-axis and dense time also
    as a share of its bound beside BEFORE_MS.  Returns per-kernel
    stats."""
    import torch
    from visfd_tpu_torch.ops import blur_cuda, dense_cuda
    from visfd_tpu_torch.ops import kernels as K

    print(f"== phase 8a: the blur's per-axis mode at halfwidths {AXIS_HWS} "
          f"on {AXIS_SHAPE} and 55 on {FILTER_SHAPE}, the fused blur at the ladder's halfwidths on "
          f"{BLOB_SHAPE}, the dense kernel on {FILTER_SHAPE} [{card}]",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    stats = {}
    x = torch.randn(AXIS_SHAPE, generator=gen, device=dev)
    nvox = x.numel()
    for hw in AXIS_HWS:
        ks = _gauss_taps(hw, dev)
        ks[0] = ks[0] * torch.linspace(0.5, 1.5, 2 * hw + 1, device=dev)
        n0 = blur_cuda.blur3_axis.launches
        got = blur_cuda.blur3(x, ks)
        chk.check(blur_cuda.blur3_axis.launches == n0 + 3,
                  f"blur3 takes the per-axis mode at hw {hw} (3 launches)")
        want, pms = timed_ms(lambda: blur_cuda.blur3_plain(x, ks))
        ok, err, _ = close(got, want, 1e-5, 1e-6)
        chk.check(ok, f"blur3_axis hw={hw} (asymmetric x taps) against "
                      f"blur3_plain: max|d|={err:.3g}")
        del want
        ms = cuda_ms(lambda: blur_cuda.blur3_axis(x, ks), 5)

        def library():
            return _blur_library(x, ks)
        lib = library()
        ok_l, err_l, _ = close(lib, got, 1e-4, 1e-5)
        chk.check(ok_l, f"conv3d per axis (library, TF32 off) == blur3_axis "
                        f"hw={hw} to rtol 1e-4: max|d|={err_l:.3g}")
        del lib, got
        lms = cuda_ms(library, 3)
        b = bound_ms(8 * nvox, 3 * BLUR_OPS_PER_TAP * (2 * hw + 1) * nvox)
        print(f"  blur3_axis hw={hw}: kernel {ms:.3f} ms (3 launches), plain "
              f"{pms:.3f} ms, conv3d per axis {lms:.3f} ms, bound "
              f"{b[0]:.3f} ms ({b[1]}) [{card}]", flush=True)
        _speed_line(f"blur3_axis hw {hw}", ms, b[0], card)
        if hw == AXIS_HWS[0]:
            stats["blur3_axis"] = {"err": err, "ms": ms, "plain_ms": pms,
                                   "bound_ms": b[0], "bound_by": b[1],
                                   "library_ms": lms}
        else:
            stats["blur3_axis"]["err"] = worst(stats["blur3_axis"]["err"],
                                               err)
    # where both run, the per-axis mode sums the fused kernel's terms
    ks = _gauss_taps(20, dev)
    a, b_ = blur_cuda.blur3(x, ks), blur_cuda.blur3_axis(x, ks)
    ok, err, _ = close(b_, a, 1e-6, 1e-7)
    nd = int(torch.count_nonzero(a.view(torch.int32) != b_.view(torch.int32)))
    chk.check(ok, f"blur3_axis == fused blur3 at hw 20: max|d|={err:.3g}, "
                  f"{nd} of {nvox} values differ in any bit")
    del x, a, b_
    torch.cuda.empty_cache()

    # the per-axis mode as 8e's -gauss 21 -w 1 launches it (the kernels
    # line reports those launches): FILTER_SHAPE, halfwidth 55, a z pass
    # of several output segments
    x = torch.randn(FILTER_SHAPE, generator=gen, device=dev)
    hw = int(np.floor(21.0 * np.sqrt(-2.0 * np.log(0.03))))
    ks = [torch.as_tensor(K.gauss_kernel_1d(21.0, hw), device=dev)
          for _ in range(3)]
    n0 = blur_cuda.blur3_axis.launches
    got = blur_cuda.blur3(x, ks)
    chk.check(hw == 55 and blur_cuda.blur3_axis.launches == n0 + 3,
              f"blur3 takes the per-axis mode for -gauss 21 (hw {hw}) at "
              f"{FILTER_SHAPE} (3 launches)")
    ok, err, _ = close(got, blur_cuda.blur3_plain(x, ks), 1e-5, 1e-6)
    chk.check(ok, f"blur3_axis hw={hw} at {FILTER_SHAPE} against "
                  f"blur3_plain: max|d|={err:.3g}")
    stats["blur3_axis"]["err"] = worst(stats["blur3_axis"]["err"], err)
    ms = cuda_ms(lambda: blur_cuda.blur3_axis(x, ks), 3)
    b = bound_ms(8 * x.numel(),
                 3 * BLUR_OPS_PER_TAP * (2 * hw + 1) * x.numel())
    _speed_line(f"blur3_axis hw {hw}", ms, b[0], card)
    del x, got
    torch.cuda.empty_cache()

    # the fused kernel at the ladder's halfwidths, at the blob run's size:
    # the wide instance (6-10) bit for bit the runtime instance, which
    # took 9-10 before it and still takes 11
    x = torch.randn(BLOB_SHAPE, generator=gen, device=dev)
    nvox = x.numel()
    for hw in LADDER_HWS:
        ks = _gauss_taps(hw, dev)
        kind = blur_cuda.instance(hw, hw, hw)
        w0 = blur_cuda.blur3.wide_launches
        got = blur_cuda.blur3(x, ks)
        chk.check(blur_cuda.blur3.wide_launches - w0 == (kind == "wide"),
                  f"blur3 hw={hw} takes the {kind} instance "
                  f"({blur_cuda.blur3.wide_launches - w0} wide launches)")
        extra = ""
        if kind == "wide":
            nb = _bits_differ(got, blur_cuda.blur3_fused(x, ks, "runtime"))
            chk.check(nb == 0, f"blur3 hw={hw} wide instance == the runtime "
                               f"instance at {BLOB_SHAPE}: {nb} words differ")
            rms = cuda_ms(lambda: blur_cuda.blur3_fused(x, ks, "runtime"), 3)
            extra = f"; the runtime instance {rms:.3f} ms"
        if hw in (6, 9):
            want, pms = timed_ms(lambda: blur_cuda.blur3_plain(x, ks))
            ok, err, _ = close(got, want, 1e-5, 1e-6)
            chk.check(ok, f"blur3 hw={hw} at {BLOB_SHAPE} against its twin: "
                          f"max|d|={err:.3g}")
            stats.setdefault("blur3", {"err": Err()})
            stats["blur3"]["err"] = worst(stats["blur3"]["err"], err)
            del want
            lib = _blur_library(x, ks)
            ok_l, err_l, _ = close(lib, got, 1e-4, 1e-5)
            chk.check(ok_l, f"conv3d per axis (library, TF32 off) == blur3 "
                            f"hw={hw} at {BLOB_SHAPE}: max|d|={err_l:.3g}")
            del lib
            lms = cuda_ms(lambda: _blur_library(x, ks), 2)
            extra += f"; plain {pms:.3f} ms, conv3d per axis {lms:.3f} ms"
        del got
        ms = cuda_ms(lambda: blur_cuda.blur3(x, ks), 3)
        b = bound_ms(8 * nvox, 3 * BLUR_OPS_PER_TAP * (2 * hw + 1) * nvox)
        print(f"  blur3 hw={hw} ({kind} instance, "
              f"{blur_cuda.smem_plan(hw, hw, hw)[0]} rows of threads): "
              f"{ms:.3f} ms at {BLOB_SHAPE}, bound {b[0]:.3f} ms ({b[1]}), "
              f"{100 * b[0] / ms:.0f}%{extra} [{card}]", flush=True)
        if kind == "wide":
            _speed_line(f"blur3 hw {hw}", ms, b[0], card)
    del x
    torch.cuda.empty_cache()

    # the dense kernel at 8e's kernels
    x = torch.randn(FILTER_SHAPE, generator=gen, device=dev)
    nvox = x.numel()
    kernels = {"-ggauss 2": K.gen_gauss_kernel_3d((2.0,) * 3, 2.0, (3,) * 3),
               "-dogg 2 4": K.dogg_kernel_3d((2.0,) * 3, (4.0,) * 3, 2.0, 2.0,
                                             -1.0, 0.03)[0]}
    for name, k in kernels.items():
        kf = torch.as_tensor(k, device=dev).flip(0, 1, 2).contiguous()
        got = dense_cuda.conv3d_dense(x, kf)
        want, pms = timed_ms(lambda: dense_cuda.conv3d_dense_plain(x, kf))
        ok, err, _ = close(got, want, 1e-5, 1e-6)
        chk.check(ok, f"conv3d_dense {name} ({'x'.join(map(str, k.shape))} "
                      f"taps) against its twin: max|d|={err:.3g}")
        del want
        lib = _conv3d_library(x, kf)
        ok_l, err_l, _ = close(lib, got, 1e-4, 1e-5)
        chk.check(ok_l, f"conv3d (library, TF32 off) == conv3d_dense {name} "
                        f"to rtol 1e-4: max|d|={err_l:.3g}")
        del lib, got
        ms = cuda_ms(lambda: dense_cuda.conv3d_dense(x, kf), 3)
        lms = cuda_ms(lambda: _conv3d_library(x, kf), 3)
        b = bound_ms(8 * nvox, 2 * k.size * nvox)
        print(f"  conv3d_dense {name}: kernel {ms:.3f} ms, plain {pms:.3f} "
              f"ms, conv3d {lms:.3f} ms, bound {b[0]:.3f} ms ({b[1]}), "
              f"{dense_cuda.dense_plan(k.shape)} [{card}]", flush=True)
        _speed_line(f"conv3d_dense {_dense_mode(k.shape)}", ms, b[0], card)
        st = stats.setdefault("conv3d_dense", {"err": Err()})
        st["err"] = worst(st["err"], err)
        if name == "-ggauss 2":
            st.update(ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                      library_ms=lms)
    del x
    torch.cuda.empty_cache()
    return stats


def _blob_diameters():
    """The ladder of ``-blob … BLOB_LADDER`` in voxels at -w BLOB_W."""
    from visfd_tpu_torch.cli import settings as S
    s = S.parse_args(f"-in x -blob minima b.txt {BLOB_LADDER}".split())
    return [d / BLOB_W for d in s.blob_diameters]


def _blob_run(chk, card, tmp, fin, fmask, stem, dev, mesh=None):
    """``filter_mrc -w 19.6 -mask M -in T -out O -blob minima B.txt
    BLOB_LADDER`` (with -mesh 4 on ``mesh``): (exit code, wall, Report,
    the launches of ``_blob_wrappers`` and the blur's wide-instance ones,
    peak card GiB, host peak RSS GiB)."""
    import torch
    from visfd_tpu_torch.ops import blur_cuda
    argv = (f"-w {BLOB_W} -mask {fmask} -in {fin} -out {stem}.mrc -blob "
            f"minima {stem}.txt {BLOB_LADDER}").split()
    if mesh is not None:
        argv += ["-mesh", str(MESH_DEVICES)]
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    wrappers = _blob_wrappers()
    for w in wrappers.values():
        w.launches = 0
    wide0 = blur_cuda.blur3.wide_launches
    with _PeakRss() as rss:
        rc, wall, rep = _run_cli(argv, dev, mesh)
    n = {k: w.launches for k, w in wrappers.items()}
    n["blur3_wide"] = blur_cuda.blur3.wide_launches - wide0
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev != "cpu" else 0.0
    return rc, wall, rep, n, peak, rss.gib


def _blob_wrappers():
    """The kernel wrappers a -blob run launches, by kernel name."""
    from visfd_tpu_torch.features import blob as TB
    from visfd_tpu_torch.ops import blur_cuda
    return {"blur3": blur_cuda.blur3,
            "blob_extremum": TB._extremum_codes_cuda}


def _blob_extremum_launches(blocks=None):
    """The extremum kernel's launches of -blob BLOB_LADDER at BLOB_SHAPE:
    one a mid scale on one device; over ``blocks`` blocks of the (2, 2)
    grid, one a z slab of a block a mid scale (``iter_windows``)."""
    from visfd_tpu_torch.features import blob as TB
    mid = len(_blob_diameters()) - 2
    if blocks is None:
        return mid
    bz, by, nx = (-(-BLOB_SHAPE[0] // 2), -(-BLOB_SHAPE[1] // 2),
                  BLOB_SHAPE[2])
    planes = max(1, min(bz, TB.SLAB_VOXELS // (by * nx)))
    return mid * blocks * -(-bz // planes)


def _read_blobs(path):
    from visfd_tpu_torch.features.blob import BlobList
    from visfd_tpu_torch.io.coords import read_blob_coords_file
    crds, diams, scores, _ = read_blob_coords_file(path)
    return BlobList(crds / BLOB_W, diams / BLOB_W, scores)


def _found_share(blobs, centres, mask):
    """The share of the phantom's centres at least 2 voxels inside the
    mask with a blob within 1 voxel."""
    import torch
    inner = []
    nz = mask.shape[0]
    lo = int(np.argmax(mask[:, 0, 0] != 0))
    hi = nz - int(np.argmax(mask[::-1, 0, 0] != 0))
    for c in centres:
        if lo + 2 <= c[0] < hi - 2:
            inner.append(c)
    inner = np.asarray(inner, np.float64)
    if not len(blobs) or not len(inner):
        return 0.0, len(inner)
    found = torch.tensor(blobs.crds[:, ::-1].copy())
    d = torch.cdist(torch.tensor(inner), found).min(1).values
    return float((d <= 1.0).double().mean()), len(inner)


def phase_blob_extremum(chk, card, dev="cuda"):
    """8g: the blob extremum kernel (``features/blob._extremum_codes_cuda``)
    on the three LoG scales around the ladder's middle mid scale of 8b's
    phantom at BLOB_SHAPE, with the phantom's mask (8b's launches) and
    without one: its codes equal to the twin's (``_extremum_masks`` and
    the sign test, run on the card: comparisons only, so exact on any
    device), ``_scale_candidates``' lists equal to the twin's codes'
    voxels and scores in raster order, one launch and no twin slab in
    its Report; the kernel's and the twin's CUDA-event times and the
    kernel's bound (13 B a voxel with the mask, 12 without).  Returns
    the kernel's stats (its time and bound with the mask)."""
    import torch
    from visfd_tpu_torch.features import blob as TB
    from visfd_tpu_torch.utils.phantom import blob_phantom
    from visfd_tpu_torch.utils.progress import Report

    sig = [d / (2 * np.sqrt(3.0)) for d in _blob_diameters()]
    k = len(sig) // 2
    tr = float(np.sqrt(-2.0 * np.log(0.03)))
    print(f"== phase 8g: the blob extremum kernel against its twin on the "
          f"LoG scales {k - 1}-{k + 1} (sigma {sig[k]:.3f}) of 8b's phantom, "
          f"{BLOB_SHAPE} [{card}]", flush=True)
    vol, mask, _, _ = blob_phantom(BLOB_SHAPE, seed=SEED + 81,
                                   n_blobs=BLOB_COUNT, device=dev)
    p, m, n = (TB.log_filter_for_scale(vol, (s,) * 3, 0.02, tr, mask)
               for s in sig[k - 1:k + 2])
    del vol
    nvox = m.numel()
    stats = {}
    for label, kw in (("mask", mask), ("no mask", None)):
        valid = None if kw is None else (kw != 0).view(torch.uint8)
        got = TB._extremum_codes_cuda(p, m, n, valid)
        (lo, hi), pms = timed_ms(lambda: TB._extremum_masks(p, m, n, kw))
        want = ((lo & (m < 0)).to(torch.uint8)
                | ((hi & (m > 0)).to(torch.uint8) << 1))
        del lo, hi
        nd = int((got != want).sum())
        err = Err(float((got.int() - want.int()).abs().max()))
        kinds = [int((want == c).sum()) for c in (1, 2)]
        chk.check(nd == 0 and min(kinds) > 0,
                  f"blob_extremum ({label}) codes == the twin's at "
                  f"{BLOB_SHAPE}: {nd} of {nvox} differ; {kinds[0]} minima, "
                  f"{kinds[1]} maxima")
        del got
        rep = Report(None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        found = TB._scale_candidates(p, m, n, kw, rep)
        sms = 1e3 * (time.perf_counter() - t0)
        same = all(
            np.array_equal(zyx, torch.nonzero(want == c).cpu().numpy())
            and np.array_equal(sc, m[want == c].cpu().numpy())
            for (zyx, sc), c in zip(found, (1, 2)))
        counts = {c: rep.counts.get(c, 0)
                  for c in (TB.KERNEL_LAUNCHES, TB.TWIN_SLABS)}
        chk.check(same and counts == {TB.KERNEL_LAUNCHES: 1,
                                      TB.TWIN_SLABS: 0},
                  f"_scale_candidates ({label}) == the twin's candidates and "
                  f"scores in raster order: {same}; counts {counts}")
        del want
        ms = cuda_ms(lambda: TB._extremum_codes_cuda(p, m, n, valid), 10)
        b = bound_ms((12 + (valid is not None)) * nvox,
                     BLOB_EXTREMUM_OPS * nvox)
        spans = ", ".join(f"{name} {1e3 * t:.3f} ms"
                          for name, t in rep.timings.items())
        print(f"  blob_extremum ({label}): kernel {ms:.3f} ms, twin "
              f"{pms:.3f} ms, bound {b[0]:.3f} ms ({b[1]}), "
              f"{100 * b[0] / ms:.1f}% of it; _scale_candidates "
              f"{sms:.3f} ms ({spans}) [{card}]", flush=True)
        if kw is not None:
            stats["blob_extremum"] = {"err": err, "ms": ms, "plain_ms": pms,
                                      "bound_ms": b[0], "bound_by": b[1],
                                      "library_ms": None}
        else:
            stats["blob_extremum"]["err"] = worst(
                stats["blob_extremum"]["err"], err)
    del p, m, n, mask
    torch.cuda.empty_cache()
    return stats


def phase_blob(chk, card, tmp, dev="cuda"):
    """8b: -blob at BLOB_SHAPE on a seeded phantom of dark spheres: scales,
    blur3 launches against the ladder's, spans, wall, memory, found
    share; 8c: the same on a BLOB_CROP crop, card against CPU.  Returns
    (input, mask, 8b's output stem, the phantom's centres, blur3
    launches, the LoG halfwidths)."""
    import torch
    from visfd_tpu_torch.features import blob as TB
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.ops import blur_cuda
    from visfd_tpu_torch.ops.filters import log_halfwidths
    from visfd_tpu_torch.utils.phantom import blob_phantom

    label = f"{'x'.join(map(str, BLOB_SHAPE[::-1]))} (X x Y x Z)"
    diams = _blob_diameters()
    sig = [d / (2 * np.sqrt(3.0)) for d in diams]
    tr = float(np.sqrt(-2.0 * np.log(0.03)))
    hws = sorted({log_halfwidths(s, 0.02, tr)[2][0] for s in sig})
    print(f"== phase 8b: filter_mrc -w {BLOB_W} -mask M -blob minima "
          f"{BLOB_LADDER}, {label}: {len(diams)} scales, LoG halfwidths "
          f"{hws[0]}-{hws[-1]} [{card}]", flush=True)
    vol, mask, centres, _ = blob_phantom(BLOB_SHAPE, seed=SEED + 81,
                                         n_blobs=BLOB_COUNT, device=dev)
    fin, fmask = os.path.join(tmp, "blob_in.mrc"), \
        os.path.join(tmp, "blob_mask.mrc")
    vol_np, mask_np = vol.cpu().numpy(), mask.cpu().numpy()
    del vol, mask
    torch.cuda.empty_cache()
    mrc.write_mrc(fin, vol_np)
    mrc.write_mrc(fmask, mask_np)
    stem = os.path.join(tmp, "blob_one")
    rc, wall, rep, launches, peak, rss = _blob_run(chk, card, tmp, fin,
                                                   fmask, stem, dev)
    n_blur = launches["blur3"]
    blobs = _read_blobs(stem + ".txt")
    out = mrc.read_mrc(stem + ".mrc").data
    chk.check(rc == 0 and out.shape == BLOB_SHAPE
              and bool(np.isfinite(out).all()) and len(blobs) > 0,
              f"{label} -blob: exit {rc}, {len(blobs)} minima, image "
              f"{out.shape} finite")
    chk.check(n_blur == 4 * len(diams),
              f"blur3 launches {n_blur} == 4 per scale x {len(diams)} scales "
              f"(two masked Gaussians: numerator and mask)")
    n_wide = 4 * sum(blur_cuda.instance(*log_halfwidths(s, 0.02, tr)[2])
                     == "wide" for s in sig)
    chk.check(launches["blur3_wide"] == n_wide,
              f"blur3 wide-instance launches {launches['blur3_wide']} == 4 "
              f"per scale at halfwidths {blur_cuda.WIDE_HALFWIDTHS} "
              f"({n_wide})")
    n_ext = _blob_extremum_launches()
    counts = {k: rep.counts.get(k, 0)
              for k in (TB.KERNEL_LAUNCHES, TB.TWIN_SLABS)}
    chk.check(launches["blob_extremum"] == n_ext
              and counts == {TB.KERNEL_LAUNCHES: n_ext, TB.TWIN_SLABS: 0},
              f"blob_extremum launches {launches['blob_extremum']} == one a "
              f"mid scale ({n_ext}); the Report counts {counts}")
    share, n_in = _found_share(blobs, centres, mask_np)
    chk.check(share >= 0.95, f"phantom centres (of {n_in} inside the mask) "
                             f"with a blob within 1 voxel: {share:.4f}")
    t = rep.timings
    n_sc = len(diams)
    print(f"  wall {wall:.3f} s; read {t.get('read the tomogram', 0):.3f} s; "
          f"LoG ladder {t['blob: LoG ladder']:.3f} s "
          f"({1e3 * t['blob: LoG ladder'] / n_sc:.1f} ms a scale); extremum "
          f"test {t['blob: extremum test']:.3f} s; compaction + copy "
          f"{t['blob: compaction + copy']:.3f} s; NMS "
          f"{t.get('blob: NMS', 0.0):.3f} s; draw spheres "
          f"{t['draw spheres']:.3f} s; copy to the host "
          f"{t['copy the result to the host']:.3f} s; write "
          f"{t['write the tomogram']:.3f} s; {n_sc} scales, {n_blur} blur3 "
          f"launches, {launches['blob_extremum']} blob_extremum launches; "
          f"peak card memory {peak:.2f} GiB; host peak RSS "
          f"{rss:.2f} GiB [{card}]", flush=True)
    del out

    # 8c: a crop, card against CPU; a blob in one list only must be a
    # near-tie (extremum margin < 1e-4)
    print(f"== phase 8c: -blob on a {BLOB_CROP} crop, card against CPU "
          f"[{card}]", flush=True)
    z0 = BLOB_SHAPE[0] // 3
    sl = (slice(z0, z0 + BLOB_CROP[0]), slice(0, BLOB_CROP[1]),
          slice(0, BLOB_CROP[2]))
    cin, cmask = os.path.join(tmp, "bc_in.mrc"), os.path.join(tmp,
                                                               "bc_mask.mrc")
    xc, mc = np.ascontiguousarray(vol_np[sl]), np.ascontiguousarray(
        mask_np[sl])
    mrc.write_mrc(cin, xc)
    mrc.write_mrc(cmask, mc)
    lists = []
    for d in (dev, "cpu"):
        cs = os.path.join(tmp, f"bc_{d}")
        _blob_run(chk, card, tmp, cin, cmask, cs, d)
        lists.append(_read_blobs(cs + ".txt"))
    ia, ib, only_a, only_b = TB.match_blob_lists(*lists)
    ok = len(ia) > 0
    ok &= bool(np.allclose(lists[0].scores[ia], lists[1].scores[ib],
                           rtol=2e-5, atol=2.0 ** -22 * np.abs(xc).max()
                           / 0.02 ** 2))
    flagged = 0
    for bl, idx in ((lists[0], only_a), (lists[1], only_b)):
        for i in idx:
            k = int(np.argmin(np.abs(np.asarray(diams) - bl.diameters[i])))
            zyx = np.round(bl.crds[i][::-1]).astype(np.int64)
            mg = TB.extremum_margins(torch.tensor(xc), sig, zyx[None], [k],
                                     torch.tensor(mc), truncate_ratio=tr)[0]
            print(f"  near-tie blob at {zyx} d={bl.diameters[i]:.4g}: "
                  f"margin {mg:.3g}")
            flagged += 1
            ok &= bool(mg < 1e-4)
    chk.check(ok, f"crop lists card == CPU: {len(ia)} blobs in both, "
                  f"{flagged} near-ties (margin < 1e-4) in one only, scores "
                  f"to rtol 2e-5 (6 digits in the files)")
    return fin, fmask, stem, centres, launches, hws


def phase_blob_tools(chk, card, tmp, blob, dev="cuda"):
    """8d: -discard-blobs -blob-separation 1.1 and -draw-spheres on 8b's
    list at BLOB_SHAPE."""
    import torch
    from visfd_tpu_torch.io import mrc
    fin, fmask, stem, centres, _, _ = blob
    print(f"== phase 8d: -discard-blobs -blob-separation 1.1, -draw-spheres "
          f"on 8b's list [{card}]", flush=True)
    nms = os.path.join(tmp, "blob_nms.txt")
    rc, wall, rep = _run_cli((f"-w {BLOB_W} -mask {fmask} -in {fin} "
                              f"-discard-blobs {stem}.txt {nms} "
                              f"-blob-separation 1.1").split(), dev)
    raw, kept = _read_blobs(stem + ".txt"), _read_blobs(nms)
    mask_np = mrc.read_mrc(fmask).data
    share, n_in = _found_share(kept, centres, mask_np)
    chk.check(rc == 0 and 0 < len(kept) < len(raw) and share >= 0.9,
              f"-discard-blobs: {len(raw)} -> {len(kept)} blobs; centres with "
              f"a kept blob within 1 voxel {share:.4f} of {n_in}")
    print(f"  -discard-blobs: wall {wall:.3f} s; {_spans(rep)} [{card}]",
          flush=True)
    fo = os.path.join(tmp, "blob_draw.mrc")
    torch.cuda.reset_peak_memory_stats()
    rc, wall, rep = _run_cli((f"-w {BLOB_W} -in {fin} -out {fo} "
                              f"-draw-spheres {nms} -foreground 5 "
                              f"-background-scale 1").split(), dev)
    out = mrc.read_mrc(fo).data
    n5 = int((out == 5).sum())
    chk.check(rc == 0 and out.shape == BLOB_SHAPE and n5 > 100 * len(kept),
              f"-draw-spheres: exit {rc}, {n5} voxels at the foreground "
              f"({len(kept)} spheres)")
    print(f"  -draw-spheres: wall {wall:.3f} s; {_spans(rep)}; peak card "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{card}]", flush=True)
    os.unlink(fo)


def phase_filters(chk, card, tmp, dev="cuda"):
    """8e: each filter of FILTER_ARGS at FILTER_SHAPE on the card (wall;
    the -gauss 21 run's per-axis launches, the -ggauss run's dense
    kernel launches), and card against CPU on a FILTER_CROP crop.
    Returns those launch counts."""
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.ops import blur_cuda, dense_cuda
    from visfd_tpu_torch.utils.phantom import blob_phantom

    label = f"{'x'.join(map(str, FILTER_SHAPE[::-1]))} (X x Y x Z)"
    print(f"== phase 8e: the filters at {label}, card against CPU on a "
          f"{FILTER_CROP} crop [{card}]", flush=True)
    vol, _, _, _ = blob_phantom(FILTER_SHAPE, seed=SEED + 82, n_blobs=800,
                                device=dev)
    vol = vol.cpu().numpy()
    fin, fcrop = os.path.join(tmp, "f_in.mrc"), os.path.join(tmp, "f_crop.mrc")
    mrc.write_mrc(fin, vol)
    z0 = FILTER_SHAPE[0] // 3
    crop = np.ascontiguousarray(vol[z0:z0 + FILTER_CROP[0],
                                    :FILTER_CROP[1], :FILTER_CROP[2]])
    mrc.write_mrc(fcrop, crop)
    del vol
    fout = os.path.join(tmp, "f_out.mrc")
    launches = {}
    for args in FILTER_ARGS:
        blur_cuda.blur3.launches = blur_cuda.blur3_axis.launches = 0
        dense_cuda.conv3d_dense.launches = 0
        rc, wall, rep = _run_cli(f"-w 1 -in {fin} -out {fout} {args}".split(),
                                 dev)
        counts = {"blur3": blur_cuda.blur3.launches,
                  "blur3_axis": blur_cuda.blur3_axis.launches,
                  "conv3d_dense": dense_cuda.conv3d_dense.launches}
        if args == "-gauss 21":
            launches["blur3_axis"] = counts["blur3_axis"]
            chk.check(counts["blur3_axis"] == 3 and counts["blur3"] == 0,
                      f"-gauss 21 (halfwidth 55) took the per-axis mode: "
                      f"{counts}")
        if args == "-ggauss 2":
            launches["conv3d_dense"] = counts["conv3d_dense"]
            chk.check(counts["conv3d_dense"] == 2,
                      f"-ggauss 2: the dense kernel, numerator and box "
                      f"denominator: {counts}")
        out = mrc.read_mrc(fout).data
        outs = []
        for d in (dev, "cpu"):
            o = os.path.join(tmp, f"fc_{d}.mrc")
            _run_cli(f"-w 1 -in {fcrop} -out {o} {args}".split(), d)
            outs.append(mrc.read_mrc(o).data)
        if args.split()[0] in FILTER_EXACT:
            nd = int((outs[0] != outs[1]).sum())
            ok, what = nd == 0, f"{nd} voxels differ"
        else:
            import torch
            atol = (2.0 ** -22 * float(np.abs(crop).max()) / 0.02 ** 2
                    if args.startswith("-log") else 1e-6)
            ok, err, _ = close(torch.tensor(outs[0]), torch.tensor(outs[1]),
                               1e-5, atol, absolute=args.startswith("-log"))
            what = f"max|d|={err:.3g}"
        chk.check(rc == 0 and out.shape == FILTER_SHAPE
                  and bool(np.isfinite(out).all()) and ok,
                  f"{args}: exit {rc}, output finite; crop card == CPU "
                  f"({what})")
        print(f"  {args}: wall {wall:.3f} s; {_spans(rep)}; launches "
              f"{counts} [{card}]", flush=True)
        del out
    for f in (fin, fcrop, fout):
        os.unlink(f)
    return launches


def phase_blob_mesh(chk, card, tmp, blob, dev="cuda"):
    """8f: -blob … -mesh 4 on one card at BLOB_SHAPE: the list and the
    image bit for bit 8b's."""
    fin, fmask, stem, _, _, _ = blob
    mesh_devs = [str(d) for row in _mesh().devices for d in row]
    print(f"== phase 8f: -blob … -mesh {MESH_DEVICES} (blocks on "
          f"{', '.join(mesh_devs)}) at "
          f"{'x'.join(map(str, BLOB_SHAPE[::-1]))} against 8b [{card}]",
          flush=True)
    mstem = os.path.join(tmp, "blob_mesh")
    rc, wall, rep, launches, peak, rss = _blob_run(
        chk, card, tmp, fin, fmask, mstem, dev, mesh=mesh_devs)
    same = open(mstem + ".txt").read() == open(stem + ".txt").read()
    chk.check(rc == 0 and same, f"-blob -mesh {MESH_DEVICES}: exit {rc}, "
                                f"list == one device's: {same}")
    n_ext = _blob_extremum_launches(MESH_DEVICES)
    chk.check(launches["blob_extremum"] == n_ext,
              f"-blob -mesh {MESH_DEVICES}: blob_extremum launches "
              f"{launches['blob_extremum']} == one a slab of a block a mid "
              f"scale ({n_ext})")
    _same_files(chk, f"-blob -mesh {MESH_DEVICES} image == one device's",
                mstem + ".mrc", stem + ".mrc")
    print(f"  wall {wall:.3f} s; {_spans(rep)}; launches {launches}; "
          f"peak card memory {peak:.2f} GiB; host peak RSS {rss:.2f} GiB "
          f"[{card}]", flush=True)
    for f in (mstem + ".txt", mstem + ".mrc"):
        os.unlink(f)


# --- phase 9: the experimental handlers, the 2-D filters, the tools ----------

EXP_SHAPE = BLOB_SHAPE          # 9a: 8b's input and mask
DENSE_YX_SHAPE = (512, 1024, 1024)  # 9a's (1, 21, 21) timing: BEFORE_MS's
EXP_ARGS = ("-template-gauss 3 6", "-doggxy 2 4 2")
EXP_CROP = (24, 48, 64)         # 9a's card-against-CPU crop, across the
#                                 mask's edge
TEMPLATE_SLAB = (16, 512, 512)  # the 31^3 kernel timed against its twin
DIST_SHAPE = MAIN_SHAPE         # 9b
DIST_POINTS = 1000
DIST_SLAB = 8                   # 9b's planes held against the CPU
RADIAL_BLOBS = 500              # 9b's -blob-radial-intensity
SPHERES = (300, 12)             # 9b's -random-spheres: count, diameter
TOOL_CROP = (64, 128, 128)      # 9c's card-against-CPU crop
KERNELS.update({
    # the dense kernel's (1, Ky, Kx) mode: -doggxy's 2-D pass (XLA's conv
    # in the JAX package, whose dogg_xy calls dense_conv3d with a
    # (1, Ky, Kx) kernel)
    "conv3d_dense_yx": ("visfd_tpu_torch/csrc/conv3d.cu",
                        "visfd_tpu/ops/conv.py:164"),
    # the dense kernel at -template-gauss 3 6's 31^3 amplitude kernel
    "conv3d_dense_31": ("visfd_tpu_torch/csrc/conv3d.cu",
                        "visfd_tpu/ops/conv.py:164"),
})


def _exp_kernels():
    """(-template-gauss 3 6 -w 1's amplitude kernel w Q_ (31^3), its
    sum |w Q_|, -doggxy 2 4 2's 2-D kernel (1, 21, 21)), as the port
    builds them."""
    from visfd_tpu_torch.ops import kernels as K
    w = K.gen_gauss_kernel_3d((6.0,) * 3, 2.0, (15,) * 3, normalize=False)
    q = K.gen_gauss_kernel_3d((3.0,) * 3, 2.0, (15,) * 3, normalize=False)
    q_ = q - float((w * q).sum() / w.sum())
    q_ = q_ / np.sqrt((w * q_ * q_).sum())
    ka = K.gen_gauss_kernel_3d((2.0, 2.0, 0.0), 2.0, (10, 10, 0))
    kb = K.gen_gauss_kernel_3d((4.0, 4.0, 0.0), 2.0, (10, 10, 0))
    return ((w * q_).astype(np.float32), float(np.abs(w * q_).sum()),
            (ka - kb).astype(np.float32))


def phase_exp_kernels(chk, card, dev="cuda"):
    """9a (kernels): the dense kernel's (1, 21, 21) mode (-doggxy's 2-D
    pass) at DENSE_YX_SHAPE and its 31^3 mode (-template-gauss's amplitude) on
    TEMPLATE_SLAB, each against its twin and cuDNN conv3d (TF32 off):
    checks, CUDA-event times, bounds, shares of the bound beside
    BEFORE_MS.  Returns per-kernel stats."""
    import torch
    from visfd_tpu_torch.ops import dense_cuda
    print(f"== phase 9a (kernels): the dense kernel's (1, 21, 21) mode on "
          f"{DENSE_YX_SHAPE}, its 31^3 mode on {TEMPLATE_SLAB} [{card}]",
          flush=True)
    k31, _, k2 = _exp_kernels()
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    stats = {}
    for name, shape, k in (("conv3d_dense_yx", DENSE_YX_SHAPE, k2),
                           ("conv3d_dense_31", TEMPLATE_SLAB, k31)):
        x = torch.randn(shape, generator=gen, device=dev)
        nvox = x.numel()
        kf = torch.as_tensor(k, device=dev).flip(0, 1, 2).contiguous()
        got = dense_cuda.conv3d_dense(x, kf)
        want, pms = timed_ms(lambda: dense_cuda.conv3d_dense_plain(x, kf))
        ok, err, _ = close(got, want, 1e-5, 1e-6)
        chk.check(ok, f"{name} ({'x'.join(map(str, k.shape))} taps, "
                      f"{shape}) against its twin: max|d|={err:.3g}")
        del want
        lib = _conv3d_library(x, kf)
        ok_l, err_l, _ = close(lib, got, 1e-4, 1e-5)
        chk.check(ok_l, f"conv3d (library, TF32 off) == {name} to rtol "
                        f"1e-4: max|d|={err_l:.3g}")
        del lib, got
        ms = cuda_ms(lambda: dense_cuda.conv3d_dense(x, kf), 3)
        lms = cuda_ms(lambda: _conv3d_library(x, kf), 2)
        b = bound_ms(8 * nvox, 2 * k.size * nvox)
        print(f"  {name}: kernel {ms:.3f} ms, plain {pms:.3f} ms, conv3d "
              f"{lms:.3f} ms, bound {b[0]:.3f} ms ({b[1]}), "
              f"{100 * b[0] / ms:.1f}%, "
              f"{dense_cuda.dense_plan(k.shape)} [{card}]", flush=True)
        _speed_line(f"conv3d_dense {_dense_mode(k.shape)}", ms, b[0], card)
        stats[name] = {"err": err, "ms": ms, "plain_ms": pms,
                       "bound_ms": b[0], "bound_by": b[1], "library_ms": lms}
        del x
        torch.cuda.empty_cache()
    return stats


def _mrc_view(path):
    """A read-only memory map of the (Z, Y, X) samples of a float32 MRC
    file (mode 2), so that a crop or a shape costs no full read."""
    with open(path, "rb") as fh:
        head = np.frombuffer(fh.read(96), "<i4")
    nx, ny, nz, mode = (int(v) for v in head[:4])
    assert mode == 2, f"{path}: mode {mode}, not float32"
    return np.memmap(path, "<f4", "r", offset=1024 + int(head[23]),
                     shape=(nz, ny, nx))


class _HeldOutput:
    """Stands in for filter_mrc's ``mrc`` module during a run: keeps the
    arrays the run writes (``arrays``, by file name) and writes them only
    when ``write`` is set."""

    def __init__(self, write):
        from visfd_tpu_torch.cli import filter_mrc as TFM
        self.tfm, self.mrc, self.write, self.arrays = TFM, TFM.mrc, write, {}

    def write_mrc(self, f, data, *args, **kw):
        self.arrays[f] = data
        if self.write:
            self.mrc.write_mrc(f, data, *args, **kw)

    def __getattr__(self, name):
        return getattr(self.mrc, name)

    def __enter__(self):
        self.tfm.mrc = self
        return self

    def __exit__(self, *exc):
        self.tfm.mrc = self.mrc


def _exp_crop_inputs(tmp, fin, fmask):
    """EXP_CROP crops of 9a's input and mask, across the mask's lower
    edge, written to files: (input file, mask file, input array)."""
    from visfd_tpu_torch.io import mrc
    z0 = EXP_SHAPE[0] // 10 - EXP_CROP[0] // 2
    sl = (slice(z0, z0 + EXP_CROP[0]), slice(0, EXP_CROP[1]),
          slice(0, EXP_CROP[2]))
    x = np.array(_mrc_view(fin)[sl])
    m = np.array(_mrc_view(fmask)[sl])
    cin, cmask = os.path.join(tmp, "ec_in.mrc"), os.path.join(tmp,
                                                               "ec_mask.mrc")
    mrc.write_mrc(cin, x)
    mrc.write_mrc(cmask, m)
    return cin, cmask, x


def phase_experimental(chk, card, tmp, blob, dev="cuda"):
    """9a: -template-gauss 3 6 and -doggxy 2 4 2 at -w 1 on 8b's input
    (EXP_SHAPE), with and without 8b's mask: launches, walls, spans, peak
    card memory; -mesh 4 (unmasked) bit for bit one device; an EXP_CROP
    crop card against CPU.  Returns (launches, {flag: unmasked output})."""
    import torch
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.ops import blur_cuda, dense_cuda
    fin, fmask = blob[0], blob[1]
    mesh_devs = [str(d) for row in _mesh().devices for d in row]
    label = f"{'x'.join(map(str, EXP_SHAPE[::-1]))} (X x Y x Z)"
    print(f"== phase 9a: {', '.join(EXP_ARGS)} at -w 1 on {label}, with and "
          f"without -mask, -mesh {MESH_DEVICES}, a {EXP_CROP} crop card "
          f"against CPU [{card}]", flush=True)
    launches, outs = {}, {}
    for args in EXP_ARGS:
        flag = args.split()[0]
        for masked in (False, True):
            # the masked run computes all of it and writes nothing (its
            # output is checked on the crop below)
            o = os.path.join(tmp, f"exp{flag}.mrc")
            argv = ((f"-mask {fmask} " if masked else f"-out {o} ")
                    + f"-w 1 -in {fin} {args}").split()
            blur_cuda.blur3.launches = dense_cuda.conv3d_dense.launches = 0
            torch.cuda.reset_peak_memory_stats()
            with _HeldOutput(write=True) as held:
                rc, wall, rep = _run_cli(argv, dev)
            counts = {"blur3": blur_cuda.blur3.launches,
                      "conv3d_dense": dense_cuda.conv3d_dense.launches}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            # -template-gauss: the background blur (numerator and, with a
            # mask, the mask's blur) and the amplitude; -doggxy: the z pass
            # and the 2-D pass
            want = {"blur3": 2 if masked and flag == "-template-gauss" else 1,
                    "conv3d_dense": 1}
            ok = rc == 0 and counts == want
            if not masked:
                one = held.arrays.get(o)
                ok &= (one is not None and one.shape == EXP_SHAPE
                       and bool(np.isfinite(one).all()))
            chk.check(ok, f"{args}{' -mask' if masked else ''}: exit {rc}"
                          f"{'' if masked else ', output finite'}; launches "
                          f"{counts} (want {want})")
            print(f"  {args}{' -mask' if masked else ''}: wall {wall:.3f} s; "
                  f"{_spans(rep)}; peak card memory {peak:.2f} GiB "
                  f"[{card}]", flush=True)
            if not masked:
                outs[flag] = o
                launches["conv3d_dense_31" if flag == "-template-gauss"
                         else "conv3d_dense_yx"] = counts["conv3d_dense"]
        # -mesh 4: its output held in memory and compared there, unwritten
        mo = os.path.join(tmp, f"exp{flag}_mesh.mrc")
        argv = (f"-w 1 -in {fin} -out {mo} {args} -mesh "
                f"{MESH_DEVICES}").split()
        with _HeldOutput(write=False) as held:
            rc, wall, rep = _run_cli(argv, dev, mesh_devs)
        out = held.arrays.get(mo)
        nd = (int((out.view(np.int32) != one.view(np.int32)).sum())
              if rc == 0 and out is not None and one is not None
              and out.shape == one.shape else -1)
        chk.check(nd == 0, f"{args} -mesh {MESH_DEVICES} == one device: "
                           f"{nd} voxels differ")
        print(f"  {args} -mesh {MESH_DEVICES}: wall {wall:.3f} s (no write); "
              f"{_spans(rep)} [{card}]", flush=True)
        del out, one, held

    # a crop, card against CPU
    cin, cmask, xc = _exp_crop_inputs(tmp, fin, fmask)
    mc = mrc.read_mrc(cmask).data
    _, wq_sum, _ = _exp_kernels()
    for args in EXP_ARGS:
        for masked in (False, True):
            res = []
            for d in (dev, "cpu"):
                o = os.path.join(tmp, f"ec_{d}.mrc")
                _run_cli(((f"-mask {cmask} " if masked else "")
                          + f"-w 1 -in {cin} -out {o} {args}").split(), d)
                res.append(torch.tensor(mrc.read_mrc(o).data))
            if masked and args.startswith("-template"):
                # masked voxels are written as 0 (settings.py:895-896)
                zero = bool((res[0].numpy()[mc == 0] == 0).all())
                chk.check(0 < int((mc == 0).sum()) < mc.size and zero,
                          f"{args} -mask on the crop (across the mask's "
                          f"edge): masked voxels 0 on the card: {zero}")
            if args.startswith("-template"):
                # absolute: the kernel w Q_ has zero mean, x - background
                # cancels (tests/test_torch_experimental.py)
                atol = 2.0 ** -20 * float(np.abs(xc).max()) * wq_sum
                ok, err, _ = close(res[0], res[1], 1e-30, atol, absolute=True)
                what = f"max|d|={err:.3g} (atol {atol:.3g})"
            else:
                ok, err, _ = close(res[0], res[1], 1e-5, 1e-6)
                what = f"max|d|={err:.3g}"
            chk.check(ok, f"{args}{' -mask' if masked else ''} on the crop: "
                          f"card == CPU ({what})")
    return launches, outs


def phase_distance(chk, card, tmp, blob, dev="cuda"):
    """9b: -distance-points (DIST_POINTS points; DIST_SLAB planes bit for
    bit the CPU's) and -distance-to-voxels (20 points' distances equal the
    CPU's) on a seeded DIST_SHAPE phantom, -random-spheres (SPHERES),
    -blob-radial-intensity min over RADIAL_BLOBS of 8b's blobs: walls."""
    from visfd_tpu_torch.features import experimental as E
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.utils.phantom import blob_phantom
    nz, ny, nx = DIST_SHAPE
    label = f"{'x'.join(map(str, DIST_SHAPE[::-1]))} (X x Y x Z)"
    print(f"== phase 9b: -distance-points ({DIST_POINTS} points), "
          f"-distance-to-voxels, -random-spheres on {label}; "
          f"-blob-radial-intensity over {RADIAL_BLOBS} of 8b's blobs "
          f"[{card}]", flush=True)
    vol, mask, _, _ = blob_phantom(DIST_SHAPE, seed=SEED + 91, n_blobs=800,
                                   device=dev)
    x, m = vol.cpu().numpy(), mask.cpu().numpy()
    del vol, mask
    fin, fmask = os.path.join(tmp, "d_in.mrc"), os.path.join(tmp,
                                                              "d_mask.mrc")
    mrc.write_mrc(fin, x)
    mrc.write_mrc(fmask, m)
    rng = np.random.default_rng(SEED + 92)
    pts = rng.uniform(0, 1, (DIST_POINTS, 3)) * np.array([nx, ny, nz])
    fpts = os.path.join(tmp, "d_pts.txt")
    np.savetxt(fpts, pts, fmt="%.3f")
    pts_vox = np.floor(np.loadtxt(fpts) + 0.5).astype(np.int64)

    fo = os.path.join(tmp, "d_out.mrc")
    for masked in (False, True):
        rc, wall, rep = _run_cli(((f"-mask {fmask} " if masked else "")
                                  + f"-w 1 -in {fin} -out {fo} "
                                  f"-distance-points {fpts}").split(), dev)
        out = mrc.read_mrc(fo).data
        z0 = nz // 2
        slab = E.distance_to_points(
            (DIST_SLAB, ny, nx), pts_vox - np.array([0, 0, z0]), 1.0,
            mask=None if not masked else m[z0:z0 + DIST_SLAB],
            background=None if not masked else x[z0:z0 + DIST_SLAB],
            device="cpu").numpy()
        nd = int((out[z0:z0 + DIST_SLAB].view(np.int32)
                  != slab.view(np.int32)).sum())
        chk.check(rc == 0 and out.shape == DIST_SHAPE and nd == 0,
                  f"-distance-points{' -mask' if masked else ''}: exit {rc}; "
                  f"{DIST_SLAB} planes card == CPU: {nd} voxels differ")
        print(f"  -distance-points{' -mask' if masked else ''}: wall "
              f"{wall:.3f} s; {_spans(rep)} [{card}]", flush=True)
    del out

    fd = os.path.join(tmp, "d_dist.txt")
    rc, wall, rep = _run_cli(f"-w 1 -in {fin} -distance-to-voxels {fpts} {fd} "
                             f"-10 -0.8".split(), dev)
    lines = open(fd).read().splitlines()
    cpu = E.distance_points_to_feature(x, pts_vox[:20], -10, -0.8, 1.0,
                                       device="cpu")
    same = lines[:20] == [f"{d}" for d in cpu]
    n_sel = int(((x >= -10) & (x <= -0.8)).sum())
    chk.check(rc == 0 and len(lines) == DIST_POINTS and same,
              f"-distance-to-voxels: exit {rc}, {len(lines)} distances, the "
              f"first 20 == the CPU's: {same}")
    print(f"  -distance-to-voxels ({n_sel} voxels selected): wall {wall:.3f} "
          f"s; {_spans(rep)} [{card}]", flush=True)

    frs = os.path.join(tmp, "d_rs.txt")
    n, diam = SPHERES
    # every brightness, inside the mask's slab
    rc, wall, rep = _run_cli(f"-w 1 -mask {fmask} -in {fin} -out {fo} "
                             f"-random-spheres {frs} {n} {diam} -10 10 "
                             f"{SEED}".split(), dev)
    occ = mrc.read_mrc(fo).data
    n_rs = len(open(frs).read().splitlines())
    chk.check(rc == 0 and n_rs == n and occ.shape == DIST_SHAPE,
              f"-random-spheres: exit {rc}, {n_rs} spheres")
    print(f"  -random-spheres {n} x {diam}: wall {wall:.3f} s; {_spans(rep)} "
          f"[{card}]", flush=True)
    del occ, x, m
    for f in (fin, fmask, fo, fd, frs):
        os.unlink(f)

    bin_, _, stem = blob[0], blob[1], blob[2]
    flist = os.path.join(tmp, "d_blobs.txt")
    with open(stem + ".txt") as src, open(flist, "w") as dst:
        for i, line in enumerate(src):
            if i == RADIAL_BLOBS:
                break
            dst.write(line)
    base = os.path.join(tmp, "d_prof")
    rc, wall, rep = _run_cli(f"-w {BLOB_W} -in {bin_} -blob-radial-intensity "
                             f"min {flist} {base}".split(), dev)
    profs = [f for f in os.listdir(tmp) if f.startswith("d_prof_")]
    chk.check(rc == 0 and len(profs) == RADIAL_BLOBS,
              f"-blob-radial-intensity min: exit {rc}, {len(profs)} profiles")
    print(f"  -blob-radial-intensity over {RADIAL_BLOBS} blobs: wall "
          f"{wall:.3f} s; {_spans(rep)} [{card}]", flush=True)
    for f in profs + ["d_blobs.txt"]:
        os.unlink(os.path.join(tmp, f))


def _tool(run, argv, **kw):
    """(exit code, wall s, stdout) of one tool run; stderr swallowed."""
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run([str(a) for a in argv], **kw)
    return rc, time.perf_counter() - t0, out.getvalue()


def _icosphere_ply(path, centre, radius, levels=3):
    """A closed icosphere (20 * 4^levels faces) as an ASCII PLY."""
    t = (1.0 + 5 ** 0.5) / 2
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
         (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
         (-t, 0, -1), (-t, 0, 1)]
    v = [np.array(p, np.float64) / np.linalg.norm(p) for p in v]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(levels):
        mid, nf = {}, []

        def m(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                p = v[a] + v[b]
                v.append(p / np.linalg.norm(p))
                mid[key] = len(v) - 1
            return mid[key]
        for a, b, c in f:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = nf
    with open(path, "w") as fh:
        fh.write(f"ply\nformat ascii 1.0\nelement vertex {len(v)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 f"element face {len(f)}\n"
                 "property list uchar int vertex_indices\nend_header\n")
        for p in v:
            q = np.asarray(centre) + radius * p
            fh.write(f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f}\n")
        for a, b, c in f:
            fh.write(f"3 {a} {b} {c}\n")
    return len(f)


def phase_tools(chk, card, tmp, blob, exp_outs, dev="cuda"):
    """9c: the nine companion tools on files earlier phases wrote (8b's
    input, mask and blob list; 9a's -template-gauss and -doggxy outputs,
    all EXP_SHAPE): walls; the three device tools card against CPU on a
    TOOL_CROP crop."""
    from visfd_tpu_torch.cli import (combine_mrc, convert_to_float, crop_mrc,
                                     draw_filter_1d, histogram_mrc,
                                     print_mrc_stats, pval_mrc, sum_voxels,
                                     voxelize_mesh)
    from visfd_tpu_torch.io import mrc
    fin, fmask, stem = blob[0], blob[1], blob[2]
    fa, fb = exp_outs["-template-gauss"], exp_outs["-doggxy"]
    nz, ny, nx = EXP_SHAPE
    print(f"== phase 9c: the nine tools on "
          f"{'x'.join(map(str, EXP_SHAPE[::-1]))} files, the device tools "
          f"card against CPU on a {TOOL_CROP} crop [{card}]", flush=True)
    walls = {}

    def tool(name, run, argv, **kw):
        rc, wall, out = _tool(run, argv, **kw)
        walls[name] = wall
        print(f"  {name} {' '.join(os.path.basename(str(a)) for a in argv)}: "
              f"exit {rc}, wall {wall:.3f} s [{card}]", flush=True)
        return rc, out

    fc = os.path.join(tmp, "t_comb.mrc")
    rc, _ = tool("combine_mrc", combine_mrc.run,
                 ["-mask", fmask, fa, "*", fb + ",0,0.01", fc], device=dev)
    chk.check(rc == 0 and _mrc_view(fc).shape == EXP_SHAPE,
              f"combine_mrc: exit {rc}")
    os.unlink(fc)
    rc, out = tool("sum_voxels", sum_voxels.run,
                   ["-mask", fmask, "-thresh2", "-1", "-0.5", "-ave", fin],
                   device=dev)
    chk.check(rc == 0 and 0.0 <= float(out) <= 1.0,
              f"sum_voxels -thresh2 -mask -ave: exit {rc}, {out.strip()}")
    # pval_mrc on the point-count image of 8b's blobs (x y z of each row)
    f3 = os.path.join(tmp, "t_pts.txt")
    crds = np.loadtxt(stem + ".txt", ndmin=2)[:, :3]
    np.savetxt(f3, crds, fmt="%.3f")
    rc, out = tool("pval_mrc", pval_mrc.run,
                   ["-image-size", nx, ny, nz, "-w", BLOB_W, "-crds", f3,
                    "-gauss-sweep", "100", "300", "1.8", "-max"], device=dev)
    rows = [ln.split() for ln in out.strip().splitlines()]
    chk.check(rc == 0 and len(rows) == 3
              and all(0.0 <= float(r[0]) <= 1.0 for r in rows),
              f"pval_mrc -gauss-sweep 100 300 1.8 -max on {len(crds)} "
              f"blobs: exit {rc}, {len(rows)} rows")
    fcr = os.path.join(tmp, "t_crop.mrc")
    rc, _ = tool("crop_mrc", crop_mrc.run,
                 [fin, fcr, 0, nx // 2 - 1, 0, ny // 2 - 1, 0, nz // 2 - 1])
    crop = mrc.read_mrc(fcr).data
    chk.check(rc == 0 and np.array_equal(
        crop, _mrc_view(fin)[:nz // 2, :ny // 2, :nx // 2]),
              f"crop_mrc: exit {rc}, {crop.shape} equal to the slice")
    ff = os.path.join(tmp, "t_float.mrc")
    rc, _ = tool("convert_to_float", convert_to_float.run, [fcr, ff])
    chk.check(rc == 0 and np.array_equal(mrc.read_mrc(ff).data, crop),
              f"convert_to_float: exit {rc}")
    del crop
    for f in (fcr, ff):
        os.unlink(f)
    rc, out = tool("print_mrc_stats", print_mrc_stats.run, [fin])
    chk.check(rc == 0 and len(out) > 0, f"print_mrc_stats: exit {rc}")
    rc, out = tool("histogram_mrc", histogram_mrc.run,
                   ["-n", "100", "-mask", fmask, fin])
    n_hist = sum(int(ln.split()[1]) for ln in out.strip().splitlines())
    n_in = int(np.count_nonzero(_mrc_view(fmask)))
    chk.check(rc == 0 and n_hist == n_in,
              f"histogram_mrc -mask: exit {rc}, {n_hist} voxels counted of "
              f"{n_in} inside the mask")
    ply, fv = os.path.join(tmp, "t_sphere.ply"), os.path.join(tmp, "t_vox.mrc")
    n_faces = _icosphere_ply(ply, (64.0, 64.0, 64.0), 40.0)
    rc, _ = tool("voxelize_mesh", voxelize_mesh.run,
                 ["-m", ply, "-o", fv, "-b", 0, 128, 0, 128, 0, 128, "-w", 1])
    vox = float(mrc.read_mrc(fv).data.sum())
    ball = 4.0 / 3.0 * np.pi * 40.0 ** 3
    chk.check(rc == 0 and abs(vox / ball - 1) < 0.02,
              f"voxelize_mesh ({n_faces} faces): exit {rc}, {vox:.0f} voxels "
              f"inside, the ball {ball:.0f}")
    for f in (ply, fv, f3):
        os.unlink(f)
    rc, out = tool("draw_filter_1d", draw_filter_1d.run,
                   ["-dogg", 1, 0.5, 2, 4, 2, 1.5])
    chk.check(rc == 0 and len(out.splitlines()) == 401,
              f"draw_filter_1d: exit {rc}")

    # the device tools, card against CPU on a crop across the mask's
    # lower edge (plane nz // 10)
    zc = max(0, nz // 10 - TOOL_CROP[0] // 2)
    sl = (slice(zc, zc + TOOL_CROP[0]), slice(0, TOOL_CROP[1]),
          slice(0, TOOL_CROP[2]))
    cfiles = []
    for f in (fa, fb, fmask, fin):
        o = os.path.join(tmp, "tc_" + os.path.basename(f))
        mrc.write_mrc(o, np.array(_mrc_view(f)[sl]))
        cfiles.append(o)
    ca, cb, cm, ci = cfiles
    res = {}
    for d in (dev, "cpu"):
        oc = os.path.join(tmp, f"tc_comb_{d}.mrc")
        r = [_tool(combine_mrc.run, ["-mask", cm, ca, "*", cb + ",0,0.01",
                                     oc], device=d)[0],
             _tool(sum_voxels.run, ["-mask", cm, "-thresh2", "-1", "-0.5",
                                    "-stddev", ci], device=d),
             _tool(pval_mrc.run, ["-in", ci, "-w", BLOB_W, "-gauss", "100",
                                  "-min", "-mask", cm], device=d)]
        res[d] = (open(oc, "rb").read(), r[1][2], r[2][2])
        os.unlink(oc)
    same_c = res[dev][0] == res["cpu"][0]
    same_s = res[dev][1] == res["cpu"][1]
    pc, pw = res[dev][2].split(), res["cpu"][2].split()
    same_p = len(pc) == len(pw) == 6 and pc[2:5] == pw[2:5] and np.allclose(
        [float(v) for v in pc[:2] + pc[5:]],
        [float(v) for v in pw[:2] + pw[5:]], rtol=1e-5)
    chk.check(same_c and same_s and same_p,
              f"the crop, card == CPU: combine_mrc bytes {same_c}, "
              f"sum_voxels line {same_s}, pval_mrc voxel and numbers "
              f"(rtol 1e-5) {same_p}")
    for f in cfiles:
        os.unlink(f)
    return walls


# ---------------------------------------------------------------------------
# phase 10: -mesh in a multi-process cluster

RANK_TIMEOUT = 240              # s: a child rank that outlives it fails
RANK_BLOCKS = 2                 # blocks a rank: two ranks make a (2, 2) grid


def cluster_rank(spec_path: str) -> int:
    """One rank of a phase-10 cluster (run in a child process with the
    VISFD_* variables set): joins with the spec's backend, runs each of
    its CLI commands with the counts and peaks reset just before and
    read just after, the ranks meeting at a barrier after each, and
    prints one ``RESULT`` JSON line (with the files the rank wrote and
    the bytes exchanged during each ``save_sharded``/``load_sharded``
    call)."""
    from datetime import timedelta
    import torch
    from visfd_tpu_torch.cli import filter_mrc as TFM
    from visfd_tpu_torch.features import blob as TB
    from visfd_tpu_torch.io import checkpoint as CK
    from visfd_tpu_torch.ops import blur_cuda, dense_cuda, eigen_cuda as EC
    from visfd_tpu_torch.ops import tv_cuda
    from visfd_tpu_torch.parallel import distributed as D
    from visfd_tpu_torch.utils.progress import Report

    spec = json.load(open(spec_path))
    D.init_distributed(backend=spec["backend"],
                       timeout=timedelta(seconds=spec["timeout"]))
    on_card = spec["device"] == "cuda"
    wrappers = {"blur3": blur_cuda.blur3,
                "hessian_principal_block": EC.hessian_principal_block,
                "tv_votes_prepadded": tv_cuda.tv_votes_prepadded,
                "sym3_score": EC.sym3_score,
                "hessian_principal": EC.hessian_principal,
                "tv_votes": tv_cuda.tv_votes,
                "conv3d_dense": dense_cuda.conv3d_dense,
                "blob_extremum": TB._extremum_codes_cuda}
    writes = []

    def spy(fn):
        def wrapped(path, *a, **k):
            writes.append(str(path))
            return fn(path, *a, **k)
        return wrapped
    TFM.mrc.write_mrc = spy(TFM.mrc.write_mrc)
    TFM.write_oriented_pointcloud_ply = spy(
        TFM.write_oriented_pointcloud_ply)
    TFM.write_blob_coords_file = spy(TFM.write_blob_coords_file)

    def spy_open(path, mode="r", *a, **k):
        # filter_mrc's own text files (lists, distances, profiles)
        if any(c in mode for c in "wax+"):
            writes.append(str(path))
        return open(path, mode, *a, **k)
    TFM.open = spy_open
    CK.open = spy_open      # the checkpoint's block files and metadata
    moved = []

    def count_traffic(fn):
        # the bytes every kind of exchange moved during a checkpoint call
        def total():
            return sum(v["bytes_sent"] + v["bytes_received"]
                       for v in D.traffic.values())

        def wrapped(*a, **k):
            before = total()
            out = fn(*a, **k)
            moved.append(total() - before)
            return out
        return wrapped
    TFM.save_sharded = count_traffic(TFM.save_sharded)
    TFM.load_sharded = count_traffic(TFM.load_sharded)
    results = []
    for run in spec["runs"]:
        writes.clear()
        moved.clear()
        D.reset_traffic()
        for w in wrappers.values():
            w.launches = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        rep = Report(None)
        with _PeakRss() as rss:
            t0 = time.perf_counter()
            rc = TFM.run(run["argv"], device=spec["device"], report=rep,
                         mesh_devices=[d.format(rank=D.process_index())
                                       for d in run["devices"]])
            wall = time.perf_counter() - t0
        results.append({
            "label": run["label"], "rc": rc, "wall": wall,
            "timings": rep.timings, "paths": rep.paths,
            "traffic": {k: dict(v) for k, v in D.traffic.items()},
            "launches": {k: w.launches for k, w in wrappers.items()},
            "card_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if on_card else 0.0),
            "rss_gib": rss.gib, "writes": list(writes),
            "counts": rep.counts, "checkpoint_moved": list(moved)})
        D.barrier()
    print("RESULT " + json.dumps({"rank": D.process_index(),
                                  "backend": D.backend(),
                                  "runs": results}), flush=True)
    D.shutdown_distributed()
    return 0


def _spawn_cluster(tmp, n, backend, runs, dev, timeout=RANK_TIMEOUT):
    """``cluster_rank`` in ``n`` child processes on a free local port.
    Returns [(exit code, stdout, stderr)] per rank; a rank that outlives
    ``timeout`` is killed, and once one fails the others get 30 s (a
    rank waiting on a collective of a dead peer would wait for the
    process group's timeout)."""
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    spec = os.path.join(tmp, f"cluster_{port}.json")
    json.dump({"backend": backend, "timeout": timeout, "runs": runs,
               "device": dev}, open(spec, "w"))
    # the host's cores shared between the ranks: torch's host threads
    # spin, and ranks that oversubscribe the cores stall each other
    env = dict(os.environ, VISFD_COORDINATOR=f"127.0.0.1:{port}",
               VISFD_NUM_PROCESSES=str(n),
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or n) // n)))
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"sys.exit(chip_smoke.cluster_rank({spec!r}))")
    # each rank's output goes to files: a rank blocked on a full pipe
    # would stall the others at their next collective
    logs = [[open(f"{spec}.{r}.{k}", "w+") for k in ("out", "err")]
            for r in range(n)]
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              env=dict(env, VISFD_PROCESS_ID=str(r)),
                              stdout=logs[r][0], stderr=logs[r][1])
             for r in range(n)]
    deadline = time.monotonic() + timeout
    notes = [""] * n
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                notes[r] = f"\nchip_smoke: rank killed after {timeout} s"
            if p.returncode != 0:
                deadline = min(deadline, time.monotonic() + 30)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    done = []
    for r, p in enumerate(procs):
        out, err = (f.seek(0) or f.read() for f in logs[r])
        done.append((p.returncode, out, err + notes[r]))
        for f in logs[r]:
            f.close()
            os.unlink(f.name)
    os.unlink(spec)
    return done


def _rank_results(chk, label, done):
    """The ranks' RESULT records, or None (and the check failed, each
    rank's error printed) when a rank failed."""
    ok = all(rc == 0 for rc, _, _ in done)
    for r, (rc, out, err) in enumerate(done):
        if rc != 0:
            print(f"    rank {r} exit {rc}:\n{err[-3000:]}")
    chk.check(ok, f"{label}: every rank exited 0 ({[d[0] for d in done]})")
    if not ok:
        return None
    return [json.loads(next(ln for ln in out.splitlines()
                            if ln.startswith("RESULT "))[7:])
            for _, out, _ in done]


def _print_rank(label, r, rec, card):
    tr = rec["traffic"]

    def t(kind):
        v = tr.get(kind, {})
        return (f"{v.get('seconds', 0.0):.3f} s, "
                f"{v.get('bytes_received', 0) / 2**20:.1f} MiB in, "
                f"{v.get('bytes_sent', 0) / 2**20:.1f} MiB out, "
                f"{v.get('calls', 0)} calls")
    tm = rec["timings"]
    print(f"  {label} rank {r}: wall {rec['wall']:.3f} s; gather "
          f"('copy the result to the host') "
          f"{tm.get('copy the result to the host', float('nan')):.3f} s, "
          f"its exchanges {t('gather')}; halo exchanges {t('halo')}; "
          f"peak card memory {rec['card_gib']:.2f} GiB; host peak RSS "
          f"{rec['rss_gib']:.2f} GiB; stages: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in tm.items())
          + f"; launches {rec['launches']} [{card}]", flush=True)


def _tv_launches(blocks):
    """The launches of the flagship over ``blocks`` blocks of a rank:
    every per-shard kernel once a block, no single-device one."""
    return {"blur3": blocks, "hessian_principal_block": blocks,
            "tv_votes_prepadded": blocks, "sym3_score": blocks,
            "hessian_principal": 0, "tv_votes": 0, "conv3d_dense": 0,
            "blob_extremum": 0}


def _cluster_checks(chk, label, recs, want_writes, want_launches):
    """Rank 0 wrote ``want_writes``, the other ranks nothing; each rank
    launched the kernels ``want_launches`` counts."""
    w0 = recs[0]["writes"]
    chk.check(all(rec["rc"] == 0 for rec in recs) and w0 == want_writes
              and all(rec["writes"] == [] for rec in recs[1:]),
              f"{label}: rank 0 wrote {len(w0)} files "
              f"{[os.path.basename(f) for f in w0[:3]]}"
              f"{' ...' if len(w0) > 3 else ''} ({len(want_writes)} "
              f"expected), the others {[rec['writes'] for rec in recs[1:]]}")
    for r, rec in enumerate(recs):
        n = rec["launches"]
        chk.check(all(n[k] == v for k, v in want_launches.items()),
                  f"{label} rank {r}: launches {n}, {want_launches} "
                  f"expected")


def phase_cluster(chk, card, tmp, mesh_files, thr, dev="cuda"):
    """10: -mesh in a multi-process cluster (10a-10c), the dry run (10d)
    and a device trace (10e).  Returns the launches of 10a per rank."""
    import torch
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.utils.phantom import membrane_phantom

    fin5, fout5 = mesh_files
    blocks = [f"{dev}:0" if dev == "cuda" else dev] * RANK_BLOCKS
    smi = subprocess.run(["free", "-g"], capture_output=True, text=True)
    print(f"== phase 10: -mesh in a multi-process cluster; host memory "
          f"(free -g):\n{smi.stdout.rstrip()}", flush=True)
    torch.cuda.empty_cache()
    shape5 = "x".join(map(str, MESH_SHAPE[::-1]))
    args5 = "-w 1 -membrane minima 3 -tv 1.5 -tv-angle-exponent 4"

    # 10a and 10b: two ranks on the one card over gloo
    vol, _ = membrane_phantom(MAIN_SHAPE, seed=SEED + 60, thickness=3.0,
                              device=dev)
    fin6 = os.path.join(tmp, "c10_in.mrc")
    mrc.write_mrc(fin6, vol.cpu().numpy())
    vol, _ = membrane_phantom(M7_SMALL, seed=SEED + 62, thickness=3.0,
                              device=dev)
    finn = os.path.join(tmp, "c10_n_in.mrc")
    mrc.write_mrc(finn, vol.cpu().numpy())
    del vol
    conn = CONNECT_ARGS.split() + ["-connect", repr(thr), "-connect-angle",
                                   "30"]
    normals = ["-select-cluster", "1", "-normals-file"]

    def runs(tag):
        o = os.path.join(tmp, f"c10_{tag}")
        return [
            ("10a", ["-in", fin5, "-out", f"{o}_a.mrc", "-mesh", "-1"]
             + args5.split()),
            ("10b", ["-in", fin6, "-out", f"{o}_b.mrc", "-mesh", "-1"]
             + conn),
            ("10b normals", ["-in", finn, "-out", f"{o}_n.mrc", "-mesh", "-1"]
             + conn + normals + [f"{o}_n.ply"]),
            ("10b -ggauss", ["-in", fin6, "-out", f"{o}_g.mrc", "-mesh", "-1",
                             "-w", "1", "-ggauss", "2"])]
    # the one-process -mesh 4 references of 10b, and the dense kernel's
    # launches in the filter's
    from visfd_tpu_torch.ops import dense_cuda
    dense_one = {}
    for lab, argv in runs("one")[1:]:
        dense_cuda.conv3d_dense.launches = 0
        rc, wall, rep = _run_cli(argv, dev, mesh=blocks * 2)
        dense_one[lab] = dense_cuda.conv3d_dense.launches
        chk.check(rc == 0 and (lab != "10b -ggauss" or dense_one[lab] > 0),
                  f"{lab} one process, -mesh 4: exit {rc}, "
                  f"{dense_one[lab]} dense-kernel launches")
        print(f"  {lab} one process, -mesh 4: wall {wall:.3f} s; "
              f"{_spans(rep)} [{card}]", flush=True)
    torch.cuda.empty_cache()
    print(f"== phase 10a/10b: two ranks on {card.split(',')[0]} over gloo, "
          f"each with blocks on {blocks}: a (2, 2) grid; 10a "
          f"filter_mrc {args5} -mesh -1 at {shape5} (5c's input); 10b "
          f"{CONNECT_ARGS} -connect T -connect-angle 30 at "
          f"{'x'.join(map(str, MAIN_SHAPE[::-1]))} (6c's input, T = "
          f"{thr!r}), with -select-cluster 1 -normals-file at "
          f"{'x'.join(map(str, M7_SMALL[::-1]))} (7d's normals size: the "
          f"host walker takes ~1 ms a vertex), and -ggauss 2 on "
          f"6c's input (the dense kernel over ghosted blocks)", flush=True)
    t0 = time.perf_counter()
    done = _spawn_cluster(tmp, 2, "gloo", [
        {"label": lab, "argv": a, "devices": blocks}
        for lab, a in runs("two")], dev)
    print(f"  the two ranks: {time.perf_counter() - t0:.1f} s with their "
          f"start-up", flush=True)
    recs = _rank_results(chk, "10a/10b two ranks over gloo", done)
    launches = None
    if recs is not None:
        for i, (lab, argv) in enumerate(runs("two")):
            for r in range(2):
                _print_rank(lab, r, recs[r]["runs"][i], card)
            want = [argv[-1], argv[3]] if lab == "10b normals" else [argv[3]]
            n = (dict(_tv_launches(0), conv3d_dense=dense_one[lab] // 2)
                 if lab == "10b -ggauss" else _tv_launches(RANK_BLOCKS))
            _cluster_checks(chk, lab, [recs[r]["runs"][i] for r in range(2)],
                            want, n)
        launches = [recs[r]["runs"][0]["launches"] for r in range(2)]
        a = mrc.read_mrc(runs("two")[0][1][3]).data
        b = mrc.read_mrc(fout5).data
        nd = int((a.view(np.int32) != b.view(np.int32)).sum())
        chk.check(a.shape == b.shape and nd == 0,
                  f"10a: two ranks' output == 5c's -mesh 4 output: {nd} "
                  f"voxels differ")
        del a, b
        for (lab, two), (_, one) in zip(runs("two")[1:], runs("one")[1:]):
            _same_files(chk, f"{lab}: two ranks' output == one process "
                             f"-mesh 4", two[3], one[3])
        ply2, ply1 = runs("two")[2][1][-1], runs("one")[2][1][-1]
        chk.check(open(ply2, "rb").read() == open(ply1, "rb").read(),
                  "10b: the -normals-file PLY of two ranks == one "
                  "process's, byte for byte")
    for _, argv in runs("two") + runs("one"):
        for f in (argv[3], argv[-1]):
            if f.endswith((".mrc", ".ply")) and os.path.exists(f) \
                    and f not in (fin5, fin6, finn):
                os.unlink(f)
    for f in (fin6, finn):
        os.unlink(f)

    # 10c: NCCL with one rank, and two ranks on one card refused
    print(f"== phase 10c: one rank over NCCL, blocks on {blocks * 2} "
          f"(-mesh 4, 5c's command); two NCCL ranks on one card refused. "
          f"Two-rank NCCL is unverified here: it needs two cards",
          flush=True)
    o = os.path.join(tmp, "c10_c.mrc")
    done = _spawn_cluster(tmp, 1, "nccl", [
        {"label": "10c", "argv": ["-in", fin5, "-out", o, "-mesh", "4"]
         + args5.split(), "devices": blocks * 2}], dev)
    recs = _rank_results(chk, "10c one rank over NCCL", done)
    if recs is not None:
        rec = recs[0]["runs"][0]
        _print_rank("10c", 0, rec, card)
        chk.check(recs[0]["backend"] == "nccl",
                  f"10c backend {recs[0]['backend']}")
        _same_files(chk, "10c: one NCCL rank's output == 5c's -mesh 4 "
                         "output", o, fout5)
        os.unlink(o)
    done = _spawn_cluster(tmp, 2, "nccl", [], dev, timeout=180)
    errs = [err for _, _, err in done]
    chk.check(all(rc != 0 for rc, _, _ in done) and all(
        "Duplicate GPU detected" in e and "backend='gloo'" in e
        for e in errs),
        f"10c: two NCCL ranks on one card raise and name the cause (exit "
        f"codes {[d[0] for d in done]}): "
        + (errs[0].strip().splitlines() or ["(no output)"])[-1])
    os.unlink(fout5)    # 5c's input stays for phase 13

    # 10d: the dry run on the card
    print(f"== phase 10d: entry.dryrun_multichip(4, devices={blocks * 2})",
          flush=True)
    from visfd_tpu_torch.entry import dryrun_multichip
    t0 = time.perf_counter()
    dryrun_multichip(4, devices=blocks * 2)
    chk.check(True, f"10d: dryrun_multichip(4) passed in "
                    f"{time.perf_counter() - t0:.1f} s [{card}]")

    # 10e: a device trace of phase 3's run
    from visfd_tpu_torch.utils.profiling import device_trace
    vol, _ = membrane_phantom(MAIN_SHAPE, seed=SEED, thickness=3.0,
                              device=dev)
    fin, fout = os.path.join(tmp, "c10_e.mrc"), os.path.join(tmp,
                                                              "c10_eo.mrc")
    mrc.write_mrc(fin, vol.cpu().numpy())
    del vol
    print(f"== phase 10e: device_trace around phase 3's run "
          f"({'x'.join(map(str, MAIN_SHAPE[::-1]))})", flush=True)
    with device_trace(os.path.join(tmp, "trace")) as prof:
        t0 = time.perf_counter()
        rc, _, _ = _run_cli(["-in", fin, "-out", fout] + args5.split(), dev)
        wall = time.perf_counter() - t0
    events = json.load(open(prof.trace_path))["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    busy = _union_us([(e["ts"], e["ts"] + e.get("dur", 0)) for e in kern])
    names = {}
    for e in kern:
        names[e["name"][:40]] = names.get(e["name"][:40], 0) + 1
    chk.check(rc == 0 and len(kern) > 0,
              f"10e: the trace {prof.trace_path} "
              f"({os.path.getsize(prof.trace_path) / 2**20:.1f} MiB) holds "
              f"{len(kern)} kernel events")
    print(f"  wall {wall:.3f} s under the profiler; the card busy "
          f"{busy / 1e6:.3f} s ({100 * busy / 1e6 / wall:.1f}% of the wall, "
          f"kernel intervals merged), idle {100 - 100 * busy / 1e6 / wall:.1f}"
          f"%; kernel events by name: "
          + ", ".join(f"{k} x{v}" for k, v in sorted(
              names.items(), key=lambda kv: -kv[1])[:12]) + f" [{card}]",
          flush=True)
    for f in (fin, fout, prof.trace_path):
        os.unlink(f)
    return launches


# ---------------------------------------------------------------------------
# phase 12: every other handler in a multi-process cluster

C12_WS_SHAPE = MAIN_SHAPE       # 12b: -watershed-device against -mesh 4
C12_SMALL = (64, 128, 128)      # 12c's inputs
C12_TIMEOUT = 360               # s: a child rank of phase 12
BLOB_CARD_GIB = 23.0            # 8b's peak card memory at twice its depth
#                                 (PERF.md section 5): an upper bound


def _blobs_inside(stem, shape, path):
    """The lines of 8b's list whose centres lie inside a (Z, Y, X)
    corner of its input, written to ``path``; their number."""
    n = 0
    with open(stem + ".txt") as src, open(path, "w") as dst:
        for line in src:
            xyz = np.array(line.split()[:3], np.float64) / BLOB_W
            if np.all((xyz >= 0) & (xyz <= np.array(shape[::-1]) - 1)):
                dst.write(line)
                n += 1
    return n


def phase_cluster_handlers(chk, card, tmp, blob, dev="cuda"):
    """12: the handlers phase 10 does not run, in two gloo ranks on the
    card, each with blocks ``["cuda:0"] * RANK_BLOCKS`` (the (2, 2) grid
    of 10a), every command in one spawn: (12a) 8b's ``-blob`` at
    BLOB_SHAPE, the list and the image against 8b's; (12b)
    ``-watershed-device -watershed-hide-boundaries`` at C12_WS_SHAPE
    against one process ``-mesh 4``, with the bytes the pointer
    jumping's all-gather moves; (12c) ``-watershed-device`` with its
    boundaries, ``-find-minima``, the host ``-watershed``,
    ``-discard-blobs`` on 8b's list, ``-draw-spheres``,
    ``-distance-points``, ``-random-spheres`` and
    ``-blob-radial-intensity`` on C12_SMALL inputs (a phantom, a corner
    of 8b's input and its blobs), each against one process ``-mesh 4``.
    Returns 12a's launches per rank."""
    import torch
    from visfd_tpu_torch.io import mrc

    fin, fmask, stem, _, one_launches, _ = blob
    blocks = [f"{dev}:0" if dev == "cuda" else dev] * RANK_BLOCKS
    torch.cuda.empty_cache()
    free, total = (torch.cuda.mem_get_info() if dev == "cuda"
                   else (0, 0))
    host = subprocess.run(["free", "-g"], capture_output=True, text=True)
    print(f"== phase 12: the other handlers in a multi-process cluster, two "
          f"ranks on {card.split(',')[0]} over gloo, blocks on {blocks} "
          f"each; card memory free {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB; host memory (free -g):\n"
          f"{host.stdout.rstrip()}", flush=True)
    if dev == "cuda":
        chk.check(free >= 2 * BLOB_CARD_GIB * 2**30,
                  f"12a: the card holds two ranks at 8b's peak "
                  f"({BLOB_CARD_GIB} GiB each): {free / 2**30:.2f} GiB free")

    def o(name):
        return os.path.join(tmp, f"c12_{name}")
    ws_in, seg, crop, blobs = o("ws_in.mrc"), o("seg.mrc"), o("crop.mrc"), \
        o("blobs.txt")
    mrc.write_mrc(ws_in, _seg_phantom(C12_WS_SHAPE, SEED + 120, dev))
    mrc.write_mrc(seg, _seg_phantom(C12_SMALL, SEED + 121, dev))
    mrc.write_mrc(crop, np.array(_mrc_view(fin)[:C12_SMALL[0],
                                                :C12_SMALL[1],
                                                :C12_SMALL[2]]))
    n_in = _blobs_inside(stem, C12_SMALL, blobs)
    w = ["-w", str(BLOB_W)]
    hidden = ["-watershed-hide-boundaries"]

    def runs(tag):
        """(label, argv without -mesh, the files it writes)."""
        def out(name):
            return o(f"{tag}_{name}")
        return [
            ("12a -blob", ["-in", fin, "-mask", fmask, "-out", out("blob.mrc")]
             + w + ["-blob", "minima", out("blob.txt")]
             + BLOB_LADDER.split(), [out("blob.txt"), out("blob.mrc")]),
            ("12b -watershed-device", ["-in", ws_in, "-out", out("wsd.mrc"),
                                       "-w", "1", "-watershed", "minima",
                                       "-watershed-device"] + hidden,
             [out("wsd.mrc")]),
            ("12c -watershed-device, boundaries",
             ["-in", seg, "-out", out("wsb.mrc"), "-w", "1", "-watershed",
              "minima", "-watershed-device"], [out("wsb.mrc")]),
            ("12c -find-minima", ["-in", seg, "-out", out("fm.mrc"), "-w",
                                  "1", "-find-minima", out("fm.txt")],
             [out("fm.txt"), out("fm.mrc")]),
            ("12c -watershed", ["-in", seg, "-out", out("ws.mrc"), "-w", "1",
                                "-watershed", "minima"], [out("ws.mrc")]),
            ("12c -discard-blobs", w + ["-discard-blobs", stem + ".txt",
                                        out("nms.txt"), "-blob-separation",
                                        "1.1"], [out("nms.txt")]),
            ("12c -draw-spheres", ["-in", crop, "-out", out("draw.mrc")] + w
             + ["-draw-spheres", blobs, "-foreground", "5"],
             [out("draw.mrc")]),
            ("12c -distance-points", ["-in", crop, "-out", out("dist.mrc")]
             + w + ["-distance-points", blobs], [out("dist.mrc")]),
            ("12c -random-spheres", ["-in", crop, "-out", out("rs.mrc")] + w
             + ["-random-spheres", out("rs.txt"), "30", "100", "-10", "10",
                str(SEED)], [out("rs.txt"), out("rs.mrc")]),
            ("12c -blob-radial-intensity", ["-in", crop, "-out",
                                            out("rad.mrc")]
             + w + ["-blob-radial-intensity", "min", blobs, out("prof")],
             [out(f"prof_{i + 1}.txt") for i in range(n_in)]
             + [out("rad.mrc")])]

    # the one-process references of 12b and 12c (8b is 12a's)
    for lab, argv, _ in runs("one")[1:]:
        rc, wall, rep = _run_cli(argv + ["-mesh", str(2 * RANK_BLOCKS)], dev,
                                 mesh=blocks * 2)
        chk.check(rc == 0, f"{lab} one process, -mesh 4: exit {rc}")
        print(f"  {lab} one process, -mesh 4: wall {wall:.3f} s; "
              f"{_spans(rep)} [{card}]", flush=True)
    torch.cuda.empty_cache()
    print(f"== phase 12a-12c: two ranks: 12a -blob minima {BLOB_LADDER} -w "
          f"{BLOB_W} -mask at {'x'.join(map(str, BLOB_SHAPE[::-1]))} (8b's "
          f"input), 12b -watershed-device at "
          f"{'x'.join(map(str, C12_WS_SHAPE[::-1]))}, 12c at "
          f"{'x'.join(map(str, C12_SMALL[::-1]))} ({n_in} of 8b's blobs in "
          f"its corner)", flush=True)
    t0 = time.perf_counter()
    done = _spawn_cluster(tmp, 2, "gloo", [
        {"label": lab, "argv": argv + ["-mesh", "-1"], "devices": blocks}
        for lab, argv, _ in runs("two")], dev, timeout=C12_TIMEOUT)
    print(f"  the two ranks: {time.perf_counter() - t0:.1f} s with their "
          f"start-up", flush=True)
    recs = _rank_results(chk, "12 two ranks over gloo", done)
    launches = None
    if recs is not None:
        for i, ((lab, _, two), (_, _, one)) in enumerate(zip(runs("two"),
                                                             runs("one"))):
            rr = [recs[r]["runs"][i] for r in range(2)]
            for r in range(2):
                _print_rank(lab, r, rr[r], card)
            want = _tv_launches(0)
            if i == 0:
                want["blur3"] = one_launches["blur3"] * RANK_BLOCKS
                want["blob_extremum"] = _blob_extremum_launches(RANK_BLOCKS)
                one = [stem + ".txt", stem + ".mrc"]
            _cluster_checks(chk, lab, rr, two, want)
            texts = [(a, b) for a, b in zip(two, one)
                     if not a.endswith(".mrc")]
            differ = [os.path.basename(a) for a, b in texts
                      if open(a, "rb").read() != open(b, "rb").read()]
            if texts:
                chk.check(not differ, f"{lab}: the two ranks' {len(texts)} "
                                      f"text files == one process's, byte "
                                      f"for byte (differ: {differ})")
            for a, b in zip(two, one):
                if a.endswith(".mrc"):
                    _same_files(chk, f"{lab}: two ranks' {os.path.basename(a)}"
                                     f" == one process's", a, b)
        launches = [recs[r]["runs"][0]["launches"] for r in range(2)]
        jumps = [recs[r]["runs"][1]["traffic"].get("pointer jump", {})
                 for r in range(2)]
        want = int(np.prod(C12_WS_SHAPE)) // 2 * 4
        secs = [round(j.get("seconds", 0.0), 3) for j in jumps]
        chk.check(all(j.get("bytes_received") == want for j in jumps),
                  f"12b: the pointer jumping's all-gather: "
                  f"{[j.get('bytes_received') for j in jumps]} bytes "
                  f"received a rank (the other rank's int32 parents, "
                  f"{want}), in {secs} s [{card}]")
    for tag in ("one", "two"):
        for _, _, files in runs(tag)[1 if tag == "one" else 0:]:
            for f in files:
                if os.path.exists(f):
                    os.unlink(f)
    for f in (ws_in, seg, crop, blobs):
        os.unlink(f)
    return launches


# ---------------------------------------------------------------------------
# phase 13: the sharded phase checkpoint

C13_SHAPE = (128, 1024, 1024)   # (Z, Y, X): 13's cut of 5c's input
C13_TIMEOUT = 300               # s: a child rank of 13b
CK_NAMES = ("vote", "saliency", "direction")
CK_CHANNELS = 6 + 1 + 3         # the checkpoint's channels a voxel


class _SaveCapture:
    """Records what filter_mrc passes to ``save_sharded``: a copy of each
    array's blocks on their devices (``arrays``: name -> [(iz, iy,
    block)]); the save itself runs only when ``write`` is set."""

    def __init__(self, write=True):
        self.write = write

    def __enter__(self):
        from visfd_tpu_torch.cli import filter_mrc as TFM
        from visfd_tpu_torch.parallel.mesh import as_blocks
        self.tfm, self.fn, self.arrays = TFM, TFM.save_sharded, {}

        def save(path, tree):
            for k, v in tree.items():
                self.arrays[k] = [(iz, iy, b.clone())
                                  for iz, iy, b in as_blocks(v).cells()]
            return self.fn(path, tree) if self.write else 0
        TFM.save_sharded = save
        return self

    def __exit__(self, *exc):
        self.tfm.save_sharded = self.fn


def _words_differ(blocks, got) -> int:
    """The 32-bit words in which ``got`` (a tensor, or a ShardedVolume of
    the same grid) differs from captured ``blocks``."""
    import torch
    from visfd_tpu_torch.parallel.mesh import ShardedVolume
    n = 0
    for iz, iy, b in blocks:
        bz, by = b.shape[-3:-1]
        g = (got.blocks[iz][iy] if isinstance(got, ShardedVolume) else
             got[..., iz * bz:(iz + 1) * bz, iy * by:(iy + 1) * by, :])
        n += int((g.view(torch.int32) != b.view(torch.int32)).sum()) \
            if g.shape == b.shape else b.numel()
    return n


def _rank_ck_files(ck, rank, ny):
    """The block files rank ``rank`` writes of a checkpoint saved over
    a grid whose row ``rank`` it holds (``ny`` blocks a row)."""
    return [f"{ck}.partial/{name}.{rank}.{iy}.npy" for name in CK_NAMES
            for iy in range(ny)]


def _gbps(nbytes, secs):
    return nbytes / secs / 1e9 if secs > 0 else float("nan")


def phase_checkpoint(chk, card, tmp, fin5, dev="cuda"):
    """13: ``-save-progress-sharded`` / ``-load-progress-sharded`` with
    5c's command on the first C13_SHAPE[0] planes of 5c's input.  (13a)
    one process: the save under ``-mesh 4`` (with ``-save-progress``, the
    ``.rec`` yardstick, in the same run), the arrays ``load_sharded``
    restores whole against those the run saved,
    and the CLI's load without a mesh and with ``-mesh 4``; (13b) two
    gloo ranks on the card save and load, and one process loads their
    checkpoint.  Every output bit for bit.  Returns the phase's
    numbers."""
    import shutil
    import torch
    from visfd_tpu_torch.io import checkpoint as CK
    from visfd_tpu_torch.io import mrc

    mesh = _mesh()
    mesh_devs = [d for row in mesh.devices for d in row]
    args = "-w 1 -membrane minima 3 -tv 1.5 -tv-angle-exponent 4".split()
    shape = C13_SHAPE
    fin = os.path.join(tmp, "c13_in.mrc")
    src = _mrc_view(fin5)
    chk.check(src.shape[1:] == shape[1:] and src.shape[0] >= shape[0],
              f"13: 5c's input {src.shape} holds {shape}")
    mrc.write_mrc(fin, np.array(src[:shape[0]]))
    del src
    ck_bytes = CK_CHANNELS * int(np.prod(shape)) * 4
    vote_bytes = 6 * int(np.prod(shape)) * 4
    du = shutil.disk_usage(tmp)
    torch.cuda.empty_cache()
    print(f"== phase 13a: -save-progress-sharded / -load-progress-sharded, "
          f"filter_mrc {' '.join(args)} at "
          f"{'x'.join(map(str, shape[::-1]))} (the first {shape[0]} planes "
          f"of 5c's input), one process, blocks on "
          f"{[str(d) for d in mesh_devs]}; disk free "
          f"{du.free / 2**30:.1f} of {du.total / 2**30:.1f} GiB [{card}]",
          flush=True)
    nums = {"shape": list(shape)}
    ck1, rec = os.path.join(tmp, "c13a_ck"), os.path.join(tmp, "c13a_rec")
    fo = os.path.join(tmp, "c13a_out.mrc")
    torch.cuda.reset_peak_memory_stats()
    with _SaveCapture() as cap, _PeakRss() as rss:
        rc, wall, rep = _run_cli(
            ["-in", fin, "-out", fo, "-mesh", str(MESH_DEVICES)] + args
            + ["-save-progress", rec, "-save-progress-sharded", ck1], dev,
            mesh=mesh_devs)
    save_s = rep.timings.get("-save-progress-sharded", float("nan"))
    rec_s = rep.timings.get("-save-progress", float("nan"))
    nb = rep.counts.get("-save-progress-sharded bytes written", 0)
    recs_f = [f"{rec}_tensor_{d}.rec" for d in range(6)]
    rec_b = sum(os.path.getsize(f) for f in recs_f if os.path.exists(f))
    nums["13a"] = {
        "save_s": save_s, "save_bytes": nb, "save_gbps": _gbps(nb, save_s),
        "rec_save_s": rec_s, "rec_bytes": rec_b,
        "rec_gbps": _gbps(rec_b, rec_s), "wall_s": wall,
        "card_gib": torch.cuda.max_memory_allocated() / 2**30,
        "rss_gib": rss.gib}
    print(f"  save -mesh {MESH_DEVICES}: wall {wall:.3f} s; "
          f"-save-progress-sharded {save_s:.3f} s for {nb} bytes "
          f"({nb / 2**30:.2f} GiB, {_gbps(nb, save_s):.2f} GB/s); the .rec "
          f"yardstick -save-progress {rec_s:.3f} s for {rec_b} bytes "
          f"({_gbps(rec_b, rec_s):.2f} GB/s, through the gather); peak "
          f"card memory {nums['13a']['card_gib']:.2f} GiB (with the "
          f"captured copies of the saved arrays); host peak RSS "
          f"{rss.gib:.2f} GiB; spans: {_spans(rep)} [{card}]", flush=True)
    chk.check(rc == 0 and nb == ck_bytes and sorted(cap.arrays)
              == sorted(CK_NAMES), f"13a save: exit {rc}, {nb} bytes "
              f"written ({ck_bytes} expected: 10 channels a voxel), arrays "
              f"{sorted(cap.arrays)}")
    saved_out = mrc.read_mrc(fo).data
    for f in [fo] + recs_f:
        if os.path.exists(f):
            os.unlink(f)

    # the arrays load_sharded restores whole (each target row reads
    # across the saved (2, 2) blocks) == those the run saved; the (2, 2)
    # grid's restore is the CLI's -mesh 4 load below
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = CK.load_sharded(ck1, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nd = {k: _words_differ(cap.arrays[k], got[k]) for k in CK_NAMES}
    nums["13a"]["load_all_s (whole)"] = secs
    chk.check(sorted(got) == sorted(CK_NAMES) and not any(nd.values()),
              f"13a: load_sharded whole == the saved arrays: words "
              f"differing {nd}; {secs:.3f} s for {ck_bytes} bytes "
              f"({_gbps(ck_bytes, secs):.2f} GB/s) [{card}]")
    del got
    del cap.arrays
    torch.cuda.empty_cache()

    # the CLI's load, without a mesh and with -mesh 4, outputs in memory
    outs = {}
    for label, extra, devs in (("no mesh", [], None),
                               ("-mesh 4", ["-mesh", str(MESH_DEVICES)],
                                mesh_devs)):
        torch.cuda.reset_peak_memory_stats()
        with _HeldOutput(False) as held, _PeakRss() as rss:
            rc, wall, rep = _run_cli(["-in", fin, "-out", fo] + args
                                     + ["-load-progress-sharded", ck1]
                                     + extra, dev, mesh=devs)
        outs[label] = held.arrays.get(fo)
        ld_s = rep.timings.get("-load-progress-sharded", float("nan"))
        lb = rep.counts.get("-load-progress-sharded bytes read", 0)
        nums["13a"][f"load ({label})"] = {
            "load_s": ld_s, "bytes": lb, "gbps": _gbps(lb, ld_s),
            "wall_s": wall,
            "card_gib": torch.cuda.max_memory_allocated() / 2**30,
            "rss_gib": rss.gib}
        print(f"  load, {label}: wall {wall:.3f} s; -load-progress-sharded "
              f"{ld_s:.3f} s for {lb} bytes ({_gbps(lb, ld_s):.2f} GB/s); "
              f"peak card memory "
              f"{nums['13a'][f'load ({label})']['card_gib']:.2f} GiB; host "
              f"peak RSS {rss.gib:.2f} GiB; spans: {_spans(rep)}; "
              f"{rep.format_paths()} [{card}]", flush=True)
        chk.check(rc == 0 and outs[label] is not None and lb == vote_bytes
                  and rep.paths.get("vote_eigen") == "plain",
                  f"13a load, {label}: exit {rc}, {lb} bytes read, the "
                  f"loaded vote scored by the full solver "
                  f"({rep.paths.get('vote_eigen')})")
    a, b = outs["no mesh"], outs["-mesh 4"]
    ok = a is not None and b is not None and a.shape == b.shape == shape
    nd = int((a.view(np.int32) != b.view(np.int32)).sum()) if ok else -1
    chk.check(ok and nd == 0 and bool(np.isfinite(a).all())
              and float(np.abs(a).max()) > 0,
              f"13a: -load-progress-sharded without a mesh == with -mesh "
              f"4: {nd} voxels differ; finite, not all 0")
    # 13b saves anew: 13a's checkpoint goes first
    shutil.rmtree(ck1, ignore_errors=True)
    torch.cuda.empty_cache()

    # 13b: two gloo ranks on the card save and load; one process loads
    blocks = [f"{dev}:0" if dev == "cuda" else dev] * RANK_BLOCKS
    ck2 = os.path.join(tmp, "c13b_ck")
    o_save, o_load = (os.path.join(tmp, f"c13b_{t}.mrc")
                      for t in ("save", "load"))
    runs = [("13b save", ["-in", fin, "-out", o_save, "-mesh", "-1"] + args
             + ["-save-progress-sharded", ck2]),
            ("13b load", ["-in", fin, "-out", o_load, "-mesh", "-1"] + args
             + ["-load-progress-sharded", ck2])]
    print(f"== phase 13b: two ranks on {card.split(',')[0]} over gloo, each "
          f"with blocks on {blocks}: the (2, 2) grid; the save, the load; "
          f"then one process loads their checkpoint without a mesh",
          flush=True)
    t0 = time.perf_counter()
    done = _spawn_cluster(tmp, 2, "gloo", [
        {"label": lab, "argv": a, "devices": blocks} for lab, a in runs],
        dev, timeout=C13_TIMEOUT)
    print(f"  the two ranks: {time.perf_counter() - t0:.1f} s with their "
          f"start-up", flush=True)
    recs = _rank_results(chk, "13b two ranks over gloo", done)
    if recs is not None:
        nums["13b"] = {}
        for i, (lab, argv) in enumerate(runs):
            rr = [recs[r]["runs"][i] for r in range(2)]
            stage = ("-save-progress-sharded" if i == 0
                     else "-load-progress-sharded")
            key = stage + (" bytes written" if i == 0 else " bytes read")
            secs = [rec["timings"].get(stage, float("nan")) for rec in rr]
            nbs = [rec["counts"].get(key, 0) for rec in rr]
            nums["13b"][lab] = {"s": secs, "bytes": nbs,
                                "gbps": [_gbps(n, t)
                                         for n, t in zip(nbs, secs)],
                                "wall_s": [rec["wall"] for rec in rr],
                                "card_gib": [rec["card_gib"] for rec in rr],
                                "rss_gib": [rec["rss_gib"] for rec in rr]}
            for r, rec in enumerate(rr):
                _print_rank(lab, r, rec, card)
            print(f"  {lab}: {stage} {secs[0]:.3f} / {secs[1]:.3f} s for "
                  f"{nbs[0]} / {nbs[1]} bytes a rank "
                  f"({_gbps(nbs[0], secs[0]):.2f} / "
                  f"{_gbps(nbs[1], secs[1]):.2f} GB/s) [{card}]", flush=True)
            want = [[argv[3]], []]
            if i == 0:
                want = [_rank_ck_files(ck2, 0, 2)
                        + [f"{ck2}.partial/metadata.json", argv[3]],
                        _rank_ck_files(ck2, 1, 2)]
            half = (ck_bytes if i == 0 else vote_bytes) // 2
            chk.check(all(rec["rc"] == 0 for rec in rr)
                      and [rec["writes"] for rec in rr] == want
                      and nbs == [half, half]
                      and all(rec["checkpoint_moved"] == [0] for rec in rr),
                      f"{lab}: each rank wrote its own files "
                      f"({[len(rec['writes']) for rec in rr]} files: the "
                      f"save its blocks, rank 0 the metadata and the "
                      f"output), {nbs} bytes a rank ({half} expected), "
                      f"bytes exchanged during the checkpoint call "
                      f"{[rec['checkpoint_moved'] for rec in rr]} (0 "
                      f"expected)")
        for label, f, want in (("13b: the two ranks' saving run == 13a's",
                                o_save, saved_out),
                               ("13b: the two ranks' load == 13a's -mesh 4 "
                                "load", o_load, outs["-mesh 4"])):
            got = mrc.read_mrc(f).data
            nd = (int((got.view(np.int32) != want.view(np.int32)).sum())
                  if want is not None and got.shape == want.shape else -1)
            chk.check(nd == 0, f"{label}: {nd} voxels differ")
        with _HeldOutput(False) as held:
            rc, wall, rep = _run_cli(["-in", fin, "-out", fo] + args
                                     + ["-load-progress-sharded", ck2], dev)
        one = held.arrays.get(fo)
        nd = (int((one.view(np.int32) != outs["no mesh"].view(np.int32))
                  .sum()) if one is not None and outs["no mesh"] is not None
              else -1)
        ld_s = rep.timings.get("-load-progress-sharded", float("nan"))
        nums["13b"]["one process load_s"] = ld_s
        chk.check(rc == 0 and nd == 0,
                  f"13b: one process without a mesh loads the two ranks' "
                  f"checkpoint: output == 13a's: {nd} voxels differ; load "
                  f"{ld_s:.3f} s, wall {wall:.3f} s [{card}]")
    for f in (o_save, o_load, fin, fin5):
        if os.path.exists(f):
            os.unlink(f)
    shutil.rmtree(ck2, ignore_errors=True)
    return nums


def _union_us(intervals):
    """Microseconds covered by the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


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
        mesh_stats = chk.run(phase_mesh_kernels, chk, card)
        mesh_small = chk.run(phase_mesh_small, chk, card)
        mesh_v_stats = chk.run(phase_mesh_stages, chk, card)
        mesh_cli = chk.run(phase_mesh_cli, chk, card, tmp)
        mesh_launches = None if mesh_cli is None else mesh_cli[0]
        connect = chk.run(phase_connect_runs, chk, card, tmp)
        if connect is not None and connect[2] is not None:
            chk.run(phase_connect_host, chk, card, connect[2], connect[0])
        chk.run(phase_connect_goldens, chk, card, tmp)
        chk.run(phase_edge_card_vs_cpu, chk, card, tmp)
        if connect is not None:
            chk.run(phase_connect_normals, chk, card, tmp, connect[0])
        seg_in = chk.run(phase_extrema, chk, card, tmp)
        chk.run(phase_watershed_host, chk, card, tmp)
        if seg_in is not None:
            chk.run(phase_watershed_device, chk, card, tmp, seg_in)
        thr = (connect if connect is not None else chk.run(
            _connect_threshold, chk, card, tmp, MAIN_SHAPE, "cuda"))
        mesh_v = None
        if thr is not None:
            mesh_v = chk.run(phase_mesh_segment, chk, card, tmp, thr[0])
        chk.run(phase_intensity, chk, card, tmp)
        filt_stats = chk.run(phase_filter_kernels, chk, card)
        ext_stats = chk.run(phase_blob_extremum, chk, card)
        blob = chk.run(phase_blob, chk, card, tmp)
        if blob is not None:
            chk.run(phase_blob_tools, chk, card, tmp, blob)
        filt_launches = chk.run(phase_filters, chk, card, tmp)
        if blob is not None:
            chk.run(phase_blob_mesh, chk, card, tmp, blob)
        exp_stats = chk.run(phase_exp_kernels, chk, card)
        exp = None
        if blob is not None:
            exp = chk.run(phase_experimental, chk, card, tmp, blob)
            chk.run(phase_distance, chk, card, tmp, blob)
        if exp is not None:
            chk.run(phase_tools, chk, card, tmp, blob, exp[1])
        cluster = None
        if mesh_cli is not None and connect is not None:
            cluster = chk.run(phase_cluster, chk, card, tmp, mesh_cli[1],
                              connect[0])
        handlers = None
        if blob is not None:
            handlers = chk.run(phase_cluster_handlers, chk, card, tmp, blob)
        checkpoint = None
        if mesh_cli is not None:
            checkpoint = chk.run(phase_checkpoint, chk, card, tmp,
                                 mesh_cli[1][0])
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if chk.failed:
        print(f"chip_smoke: {len(chk.failed)} check(s) failed:",
              file=sys.stderr)
        for f in chk.failed:
            print(f"  {f}", file=sys.stderr)
        return 1
    launches, main_errs = main_path
    # launches: the main path's run (phase 3) for the single-device
    # kernels, the -mesh run (5c) for the per-shard modes, the -connect
    # runs for the vote score with its vector: one device (6c) and, per
    # block, -mesh (7d); 8e's -gauss 21 (halfwidth 55) for the blur's
    # per-axis mode and its -ggauss 2 for the dense kernel; 9a's -doggxy
    # and -template-gauss runs for the dense kernel's 2-D and 31^3 modes;
    # 8b's -blob for the blob extremum kernel
    launches = {**launches, **exp[0],
                "blob_extremum": blob[4]["blob_extremum"],
                **{k: mesh_launches[k] for k in ("hessian_principal_block",
                                                 "tv_votes_prepadded")},
                "sym3_score+v": connect[1]["sym3_score"],
                "sym3_score_sharded+v": mesh_v, **filt_launches}
    stats = {**stats, **mesh_stats, **mesh_v_stats,
             "blur3_axis": filt_stats["blur3_axis"],
             "conv3d_dense": filt_stats["conv3d_dense"], **exp_stats,
             **ext_stats}
    stats["blur3"]["err"] = worst(stats["blur3"]["err"],
                                  filt_stats["blur3"]["err"])
    errs = [small, main_errs, mesh_small]
    # each rank's launches in 10a and 12a
    ranks = [c for c in (cluster, handlers) if c is not None]
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        s = stats[name]
        err = worst(s["err"], *[e.get(name, Err()) for e in errs])
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err[0], "max_rel_err": err[1],
                        "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"],
                        "library_shape": s.get("library_shape"),
                        "cluster_launches": None if not ranks
                        or name not in ranks[0][0] else
                        [sum(c[r][name] for c in ranks) for r in range(2)]})
    import torch
    print(json.dumps({"checkpoint": checkpoint}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase_cards(chk, card, tmp, n, dev="cuda", backend="nccl"):
    """11 (``--nccl``): -mesh with one card a rank over NCCL on ``n``
    cards (and on 2): 5c's command at 537M and 6c's -connect, each
    against the one-process -mesh run over the same cards, bit for
    bit."""
    import torch
    from visfd_tpu_torch.io import mrc
    from visfd_tpu_torch.utils.phantom import membrane_phantom

    rank_dev = ["cuda:{rank}"] if dev == "cuda" else [dev]
    cards = [f"cuda:{i}" for i in range(n)] if dev == "cuda" else [dev] * n
    thr, fin6 = _connect_threshold(chk, card, tmp, MAIN_SHAPE, dev)
    vol, _ = membrane_phantom(CARDS_SHAPE, seed=SEED + 53, thickness=3.0,
                              device=dev)
    fin5 = os.path.join(tmp, "c11_in.mrc")
    mrc.write_mrc(fin5, vol.cpu().numpy())
    del vol
    torch.cuda.empty_cache()
    args5 = "-w 1 -membrane minima 3 -tv 1.5 -tv-angle-exponent 4".split()
    conn = CONNECT_ARGS.split() + ["-connect", repr(thr), "-connect-angle",
                                   "30"]
    ref = os.path.join(tmp, "c11_ref.mrc")
    for k in sorted({2, n}):
        for lab, fin, args in ((f"11a ({k} ranks)", fin5, args5),
                               (f"11b ({k} ranks)", fin6, conn)):
            print(f"== phase {lab}: {k} ranks over {backend}, one card "
                  f"each, -mesh -1, against one process -mesh {k} over "
                  f"{cards[:k]} [{card}]", flush=True)
            one, two = (os.path.join(tmp, f"c11_{t}.mrc")
                        for t in ("one", "ranks"))
            if lab == f"11a ({n} ranks)":
                one = ref       # kept for 13c
            rc, wall, rep = _run_cli(["-in", fin, "-out", one, "-mesh",
                                      str(k)] + args, dev, mesh=cards[:k])
            chk.check(rc == 0, f"{lab} one process: exit {rc}")
            print(f"  one process, -mesh {k}: wall {wall:.3f} s; "
                  f"{_spans(rep)} [{card}]", flush=True)
            done = _spawn_cluster(tmp, k, backend, [
                {"label": lab, "argv": ["-in", fin, "-out", two, "-mesh",
                                        "-1"] + args,
                 "devices": rank_dev}], dev)
            recs = _rank_results(chk, f"{lab} over {backend}", done)
            if recs is None:
                continue
            runs = [rec["runs"][0] for rec in recs]
            for r, rec in enumerate(runs):
                _print_rank(lab, r, rec, card)
                # an exchange's clock holds its transfer: no faster than
                # NVLink's 900 GB/s
                g = rec["traffic"].get("gather", {})
                nb = g.get("bytes_received", 0)
                chk.check(g.get("seconds", 0.0) >= nb / 900e9,
                          f"{lab} rank {r}: the gather's exchanges "
                          f"{g.get('seconds', 0.0):.4f} s for {nb} bytes "
                          f"received, at least {nb / 900e9:.4f} s at 900 "
                          f"GB/s")
            chk.check(all(rec["backend"] == backend for rec in recs),
                      f"{lab}: backend {[rec['backend'] for rec in recs]}")
            _cluster_checks(chk, lab, runs, [two], _tv_launches(1))
            _same_files(chk, f"{lab}: the ranks' output == one process's",
                        two, one)
            for f in (one, two):
                if f != ref:
                    os.unlink(f)
    phase_checkpoint_cards(chk, card, tmp, n, fin5, ref, dev, backend)
    for f in (fin5, fin6, ref):
        if os.path.exists(f):
            os.unlink(f)


def phase_checkpoint_cards(chk, card, tmp, n, fin5, ref, dev="cuda",
                           backend="nccl"):
    """13c (``--nccl``): ``n`` ranks, one card each, save 5c's run
    with ``-save-progress-sharded``; two ranks and one process ``-mesh
    4`` (``-mesh 2`` on two cards) load the checkpoint: the saving run's
    output equals 11a's one process (``ref``), the loads equal each
    other, the checkpoint's arrays equal those one process ``-mesh n``
    computes without it, each rank writes its own blocks and exchanges
    nothing during the save and the load."""
    import shutil
    from visfd_tpu_torch.io import checkpoint as CK
    from visfd_tpu_torch.parallel.mesh import _grid_shape, make_mesh
    rank_dev = ["cuda:{rank}"] if dev == "cuda" else [dev]
    cards = [f"cuda:{i}" for i in range(n)] if dev == "cuda" else [dev] * n
    k1 = min(4, n)
    args5 = "-w 1 -membrane minima 3 -tv 1.5 -tv-angle-exponent 4".split()
    ck = os.path.join(tmp, "c13c_ck")
    o_save, o_two, o_one = (os.path.join(tmp, f"c13c_{t}.mrc")
                            for t in ("save", "two", "one"))
    print(f"== phase 13c: {n} ranks over {backend}, one card each, save 5c's "
          f"run with -save-progress-sharded; 2 ranks and one process -mesh "
          f"{k1} load it; disk free "
          f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB [{card}]",
          flush=True)
    for lab, k, argv in (
            ("13c save", n, ["-in", fin5, "-out", o_save, "-mesh", "-1"]
             + args5 + ["-save-progress-sharded", ck]),
            ("13c load", 2, ["-in", fin5, "-out", o_two, "-mesh", "-1"]
             + args5 + ["-load-progress-sharded", ck])):
        done = _spawn_cluster(tmp, k, backend, [
            {"label": lab, "argv": argv, "devices": rank_dev}], dev)
        recs = _rank_results(chk, f"{lab} over {backend}", done)
        if recs is None:
            continue
        runs = [rec["runs"][0] for rec in recs]
        stage = ("-save-progress-sharded" if lab == "13c save"
                 else "-load-progress-sharded")
        for r, rec in enumerate(runs):
            _print_rank(lab, r, rec, card)
            print(f"  {lab} rank {r}: {stage} "
                  f"{rec['timings'].get(stage, float('nan')):.3f} s, "
                  f"{rec['counts']} [{card}]", flush=True)
        # rank r drives card r, block (r // ny, r % ny) of the grid
        want = [[argv[3]]] + [[] for _ in runs[1:]]
        if lab == "13c save":
            ny = _grid_shape(n)[1]
            want = [[f"{ck}.partial/{name}.{r // ny}.{r % ny}.npy"
                     for name in CK_NAMES] for r in range(n)]
            want[0] += [f"{ck}.partial/metadata.json", argv[3]]
        chk.check([rec["writes"] for rec in runs] == want
                  and all(rec["checkpoint_moved"] == [0] for rec in runs),
                  f"{lab}: each rank wrote its own files "
                  f"({[len(rec['writes']) for rec in runs]} files), bytes "
                  f"exchanged during the checkpoint call "
                  f"{[rec['checkpoint_moved'] for rec in runs]} (0 expected)")
    rc, wall, rep = _run_cli(["-in", fin5, "-out", o_one, "-mesh", str(k1)]
                             + args5 + ["-load-progress-sharded", ck], dev,
                             mesh=cards[:k1])
    chk.check(rc == 0, f"13c load, one process -mesh {k1}: exit {rc}; "
                       f"wall {wall:.3f} s; {_spans(rep)} [{card}]")
    # the checkpoint's contents against a run that does not read it: one
    # process -mesh n over the same cards computes the arrays it would
    # save (held on the cards, not written), and load_sharded restores
    # the ranks' checkpoint onto that grid; every block bit for bit, so
    # a rank that wrote another cell's data under its name shows here
    mesh_n = make_mesh(n, devices=cards)
    with _SaveCapture(write=False) as cap, _HeldOutput(False):
        rc, wall, _ = _run_cli(["-in", fin5, "-out", o_one + ".ref",
                                "-mesh", str(n)] + args5
                               + ["-save-progress-sharded", ck + ".ref"],
                               dev, mesh=cards)
    got = CK.load_sharded(ck, like=mesh_n) if rc == 0 else {}
    nd = {k: (_words_differ(cap.arrays[k], got[k])
              if k in got and k in cap.arrays else -1) for k in CK_NAMES}
    chk.check(rc == 0 and not any(nd.values()),
              f"13c: the {n} ranks' checkpoint == the arrays one process "
              f"-mesh {n} computes without it: words differing {nd} "
              f"(exit {rc}, wall {wall:.3f} s) [{card}]")
    del got, cap
    if os.path.exists(o_save):
        _same_files(chk, f"13c: {n} ranks' saving run == one process "
                         f"-mesh {n}", o_save, ref)
    if os.path.exists(o_two) and os.path.exists(o_one):
        _same_files(chk, f"13c: 2 ranks' load == one process -mesh {k1}'s",
                    o_two, o_one)
    for f in (o_save, o_two, o_one):
        if os.path.exists(f):
            os.unlink(f)
    shutil.rmtree(ck, ignore_errors=True)


def nccl_main() -> int:
    """``python3 chip_smoke.py --nccl``, on a machine with two or more
    cards: the kernels' build and phase 11."""
    import torch
    card = phase_card()
    if card is None:
        return 2
    n = torch.cuda.device_count()
    if n < 2:
        print(f"chip_smoke --nccl: needs two cards or more, sees {n}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    chk = Checks()
    if chk.run(phase_build, chk) is None:
        return 1
    with tempfile.TemporaryDirectory(prefix=".tmp_chip_smoke_",
                                     dir=ROOT) as tmp:
        chk.run(phase_cards, chk, card, tmp, n)
    for f in chk.failed:
        print(f"  failed: {f}", file=sys.stderr)
    print(json.dumps({"ok": not chk.failed, "cards": n}))
    return 1 if chk.failed else 0


if __name__ == "__main__":
    sys.exit(nccl_main() if sys.argv[1:] == ["--nccl"] else main())
