"""Separable 3-D convolution: the CUDA kernel (``csrc/blur.cu``), its
plain PyTorch twin, and the wrapper that picks one by the tensor's
device.  On the card ``instance`` picks the kernel's instance by the
halfwidths: the wide instance for one of ``WIDE_HALFWIDTHS`` on every
axis, a compiled one for a halfwidth 1-5 on every axis, the
runtime one for other widths a tile holds, and the per-axis mode
(``blur3_axis``: one launch per axis) for halfwidths whose fused tile
does not fit in shared memory, as the JAX package sends kernels longer
than 61 taps to XLA's conv1d (``visfd_tpu/ops/conv.py:96-103``).  Every
instance sums the same terms in the same order, so the choice moves no
bit.

Port of ``visfd_tpu/ops/blur_pallas.py`` (``blur3_pallas``).  Semantics
of ``ops.conv._sep3``: true convolution g[i] = sum_j h[j] f[i-j] along
each axis, with zero padding; the 1-D kernels are runtime values of odd
length.  The twin sums z, then y, then x; the kernel x, then y, then z
(the TPU kernel y, x, z), which the tolerances cover.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from visfd_tpu_torch import _cuda_build as cb


def conv1d_axis(x: torch.Tensor, kernel: torch.Tensor,
                axis: int) -> torch.Tensor:
    """1-D convolution g[i] = sum_j h[j] * f[i-j] along ``axis`` with
    zero padding, as a sum of shifted copies; kernel length is odd."""
    klen = kernel.shape[0]
    hw = klen // 2
    if hw == 0:
        return x * kernel[0]
    n = x.shape[axis]
    pad = [0, 0] * x.ndim
    # F.pad lists the last axis first
    pad[2 * (x.ndim - 1 - axis)] = hw
    pad[2 * (x.ndim - 1 - axis) + 1] = hw
    xp = torch.nn.functional.pad(x, pad)
    out = None
    for t in range(klen):
        term = xp.narrow(axis, t, n) * kernel[klen - 1 - t]
        out = term if out is None else out + term
    return out


def blur3_plain(x: torch.Tensor, kernels_xyz: Sequence) -> torch.Tensor:
    """The twin of the kernel: three shift-sum passes, z then y then x."""
    kx, ky, kz = kernels_xyz
    out = conv1d_axis(x, kz, axis=0)
    out = conv1d_axis(out, ky, axis=1)
    return conv1d_axis(out, kx, axis=2)


SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper


_STAGES = 3        # staged input planes (csrc/blur.cu)
_MAX_FIXED = 5     # one halfwidth 1-5 on every axis is compile-time
_FIXED_ROWS = 8    # its rows of threads, 4 output rows each
# the wide instance (csrc/blur.cu, blur3_kernel_wide): the halfwidths it
# takes (the same on every axis), its warps (4 output rows each, so a
# 32 x 32 tile), its staged planes and its blocks an SM
WIDE_HALFWIDTHS = (6, 7, 8, 9, 10)
_WIDE_WARPS = 8
_WIDE_STAGES = 4
_WIDE_BLOCKS_PER_SM = 2


def _runtime_plan(hx: int, hy: int, hz: int):
    """The runtime instance's (rows of threads, shared-memory bytes): one
    output row per thread, the most of 8, 4, 2, 1 rows that fit beside a
    ring of 2hz+1 xy-blurred planes of the tile and the taps; None when
    none fits."""
    for rows in (8, 4, 2, 1):
        nbytes = _fused_bytes(hx, hy, hz, rows, True)
        if nbytes <= SMEM_LIMIT:
            return rows, nbytes
    return None


def _fused_bytes(hx, hy, hz, tile_rows, ring):
    """Three staged (tile rows + 2hy) x (32 + 2hx) input planes and two
    planes of x-blurred rows, all float32, and with ``ring`` the ring of
    2hz+1 xy-blurred planes and the taps."""
    ry, sx = tile_rows + 2 * hy, 32 + 2 * hx
    extra = (2 * hz + 1) * 32 * tile_rows + 2 * (hx + hy + hz) + 3
    return 4 * (_STAGES * ry * sx + 2 * 32 * ry + (extra if ring else 0))


def _wide_bytes(h: int) -> int:
    """The wide instance's shared memory at halfwidth h (its WideTile):
    four staged (32 + 2h) x (32 + 2a + 4) input planes, a the x halo
    rounded up to 4 floats (16-byte rows, each padded by 4 so that
    two rows of a warp's float4 reads take other banks), two planes of
    x-blurred rows 36 floats apart, and the three axes' taps, each
    padded to a multiple of 4."""
    a = -(-h // 4) * 4
    ry = 4 * _WIDE_WARPS + 2 * h
    return 4 * (_WIDE_STAGES * ry * (32 + 2 * a + 4) + 2 * ry * 36
                + 3 * (-(-(2 * h + 1) // 4) * 4))


def instance(hx: int, hy: int, hz: int) -> str:
    """The instance of ``csrc/blur.cu`` that blurs at halfwidths (hx, hy,
    hz): "wide" (one of WIDE_HALFWIDTHS on every axis), "compiled"
    (a halfwidth 1-5 on every axis), "runtime" (other widths whose
    tile fits) or "axis" (none fits: the per-axis mode)."""
    if hx == hy == hz and hx in WIDE_HALFWIDTHS:
        return "wide"
    if hx == hy == hz and 1 <= hx <= _MAX_FIXED:
        return "compiled"
    return "runtime" if _runtime_plan(hx, hy, hz) else "axis"


def smem_plan(hx: int, hy: int, hz: int):
    """(rows of threads, dynamic shared-memory bytes) of the fused
    kernel's instance for the halfwidths (hx, hy, hz), or None when no
    tile fits.  The wide instance takes 8 rows of threads (warps) and a
    32-row tile; a compiled one 8 rows of threads and a 32-row tile
    (three staged planes and two of x-blurred rows); the runtime one
    ``_runtime_plan``."""
    kind = instance(hx, hy, hz)
    if kind == "wide":
        return _WIDE_WARPS, _wide_bytes(hx)
    if kind == "compiled":
        return _FIXED_ROWS, _fused_bytes(hx, hy, hz, 4 * _FIXED_ROWS, False)
    return _runtime_plan(hx, hy, hz)


# the largest halfwidth (on every axis) whose tile fits
MAX_KERNEL_HALFWIDTH = max(h for h in range(1, 256)
                           if smem_plan(h, h, h) is not None)


@functools.lru_cache(maxsize=256)
def wide_chunk(shape, h: int, n_sm: int) -> int:
    """Output planes a block of the wide instance marches over for a
    (Z, Y, X) ``shape`` at halfwidth h on a card of ``n_sm`` SMs: of the
    splits of the depth, the one whose waves of blocks (two an SM) times
    the planes of the volume a block stages (its chunk and 2h halo
    planes) is least.  The chunk moves no output bit."""
    nz, ny, nx = shape
    tiles = -(-nx // 32) * -(-ny // (4 * _WIDE_WARPS))
    best = None
    for tz in sorted({-(-nz // c) for c in range(1, nz + 1)}, reverse=True):
        waves = -(-tiles * -(-nz // tz) // (_WIDE_BLOCKS_PER_SM * n_sm))
        cost = waves * min(tz + 2 * h, nz)
        if best is None or cost < best[0]:
            best = (cost, tz)
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def blur3(x: torch.Tensor, kernels_xyz: Sequence) -> torch.Tensor:
    """Separable 3-D convolution of a (Z, Y, X) float32 volume with the
    1-D kernels (kx, ky, kz).  A CPU tensor takes the plain twin; a
    CUDA tensor launches ``csrc/blur.cu`` (one fused launch of the
    instance ``instance`` picks, or the per-axis mode)."""
    ks = [torch.as_tensor(k, dtype=torch.float32, device=x.device)
          for k in kernels_xyz]
    if any(k.ndim != 1 or k.shape[0] % 2 == 0 for k in ks):
        raise ValueError("blur3 kernels must be 1-D of odd length")
    if x.device.type == "cpu":
        return blur3_plain(x, ks)
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"blur3 takes a (Z, Y, X) float32 CPU or CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    kind = instance(*(k.shape[0] // 2 for k in ks))
    if kind == "axis":
        return blur3_axis(x, ks)
    return blur3_fused(x, ks, kind)


def blur3_fused(x: torch.Tensor, ks: Sequence[torch.Tensor],
                kind: str) -> torch.Tensor:
    """One launch of ``csrc/blur.cu``'s fused kernel on a (Z, Y, X)
    float32 CUDA tensor with the 1-D kernels (kx, ky, kz), float32 on its
    device, as the instance ``kind``: "wide" or "compiled" where
    ``instance`` takes them, "runtime" where it takes the runtime or the
    wide instance (chip_smoke.py times the wide instance against the
    runtime one it replaced).  Counts its
    launch on ``blur3.launches`` and a wide one on
    ``blur3.wide_launches``."""
    kx, ky, kz = ks
    hx, hy, hz = (k.shape[0] // 2 for k in ks)
    # the runtime instance also takes the wide widths (its parent), never
    # a compiled one's: the C entry would launch the compiled instance
    if instance(hx, hy, hz) not in {"wide": ("wide",),
                                    "compiled": ("compiled",),
                                    "runtime": ("runtime", "wide")}[kind]:
        raise ValueError(f"blur3: the {kind} instance does not take "
                         f"halfwidths {(hx, hy, hz)}")
    plan = (_runtime_plan(hx, hy, hz) if kind == "runtime"
            else smem_plan(hx, hy, hz))
    if x.shape[1] * x.shape[2] >= 2 ** 31:
        raise ValueError(f"blur3: a plane of {tuple(x.shape[1:])} voxels "
                         f"exceeds the kernel's 32-bit plane offsets")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    nz, ny, nx = x.shape
    taps = torch.cat([kz, ky, kx]).contiguous()
    lib = cb.library()
    with torch.cuda.device(x.device):
        if kind == "wide":
            tz = wide_chunk(tuple(x.shape), hx, _sm_count(x.device.index))
            cb.check(lib.visfd_blur3_wide(
                x.data_ptr(), out.data_ptr(), taps.data_ptr(), hx, nz, ny,
                nx, tz, plan[1], cb.stream_of(x)), "visfd_blur3_wide")
            blur3.wide_launches += 1
        else:
            cb.check(lib.visfd_blur3(
                x.data_ptr(), out.data_ptr(), taps.data_ptr(), hx, hy, hz,
                nz, ny, nx, *plan, cb.stream_of(x)), "visfd_blur3")
    blur3.launches += 1
    return out


blur3.launches = 0
blur3.wide_launches = 0


def blur3_axis(x: torch.Tensor, kernels_xyz: Sequence) -> torch.Tensor:
    """``blur3`` of a (Z, Y, X) float32 CUDA tensor by the kernel's
    per-axis mode: x, then y, then z, one launch each, any halfwidth
    (each output sums its taps in the fused kernel's order)."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"blur3_axis takes a (Z, Y, X) float32 CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    nz, ny, nx = x.shape
    if -(-nz * ny // 32) >= 2 ** 31 or max(nx, ny, nz) > 128 * 65535 or \
            nz > 65535 or -(-ny * nx // 32) >= 2 ** 31:
        raise ValueError(f"blur3_axis: {tuple(x.shape)} exceeds the "
                         f"kernel's grid")
    src = x.contiguous()
    if src.numel() == 0:
        return torch.empty_like(src)
    ks = [torch.as_tensor(k, dtype=torch.float32, device=x.device)
          .contiguous() for k in kernels_xyz]
    tmp = torch.empty_like(src)
    out = torch.empty_like(src)
    lib = cb.library()
    # x: src -> tmp, y: tmp -> out, z: out -> tmp
    with torch.cuda.device(x.device):
        for axis, (a, b) in ((2, (src, tmp)), (1, (tmp, out)),
                             (0, (out, tmp))):
            k = ks[2 - axis]
            cb.check(lib.visfd_blur_axis(
                a.data_ptr(), b.data_ptr(), k.data_ptr(), k.shape[0] // 2,
                nz, ny, nx, axis, cb.stream_of(x)), "visfd_blur_axis")
            blur3_axis.launches += 1
    return tmp


blur3_axis.launches = 0
