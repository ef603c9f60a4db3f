"""Dense 3-D correlation with zero padding: the CUDA kernel
(``csrc/conv3d.cu``), its plain PyTorch twin, and the wrapper that picks
one by the tensor's device.

The JAX package computes its dense convolutions in XLA
(``visfd_tpu/ops/conv.py:_dense_conv3d_impl``, ``conv_general_dilated``
at ``Precision.HIGHEST``).  Here ``conv3d_dense`` takes the kernel
already flipped (``ops.conv.dense_conv3d`` flips it): out[p] = sum over
the taps t, in ascending (z, y, x) order, of k[t] * x[p - h + t], zero
outside the volume.  Both the kernel and the twin sum in that order
with no reordering that depends on the volume's shape, so a block of a
``-mesh`` run read with a deep enough halo gives its interior the
single-device values bit for bit (the kernel fuses each product into
its sum, the twin does not: the tolerances cover that).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from visfd_tpu_torch import _cuda_build as cb

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper

_WARPS = 8           # output rows a tile (csrc/conv3d.cu, one a warp)
_TX = 128            # output columns a tile (4 a lane)
_RUNTIME_TZ = 4      # output planes a block of the runtime instance
# the compiled kernel shapes (wz, wy, wx): (variant, output planes a
# block); the CLI launches 7^3 at -ggauss 2, 15^3 at -dogg 2 4, 5^3 at
# -fluct 3 -exponent 3, (1, 21, 21) at -doggxy 2 4 2 and 31^3 at
# -template-gauss 3 6 (all at -w 1)
COMPILED = {(3, 3, 3): (1, 8), (5, 5, 5): (2, 8), (7, 7, 7): (3, 8),
            (15, 15, 15): (4, 8), (1, 21, 21): (5, 4), (31, 31, 31): (6, 4)}


class DensePlan(NamedTuple):
    """How ``csrc/conv3d.cu`` runs one kernel shape: the instance
    (``variant``: 1-6 a compiled shape, 0 the runtime one), dynamic
    shared bytes, staged units in the ring, kernel rows a staged unit,
    and whether the taps sit in shared memory (else they are read
    through L1).  A block's tile is _WARPS rows by _TX columns by the
    instance's output planes (COMPILED, else _RUNTIME_TZ)."""
    variant: int
    smem: int
    stages: int
    band: int
    smem_taps: bool


def dense_plan(kshape) -> Optional[DensePlan]:
    """The launch plan of ``conv3d_dense`` for an odd-sided (wz, wy, wx)
    kernel, or None when not even one kernel row a unit fits in shared
    memory (a row of some 3,500 taps).  A unit stages (8 + band - 1)
    rows of 128 + wxp floats, wxp the row padded to a multiple of 4;
    compiled shapes keep the whole padded kernel and three units; the
    runtime instance keeps as much of that as fits, in this order: taps
    in shared memory with 3, then 2 units; taps through L1 with 3, then
    2 units; then bands of fewer kernel rows."""
    wz, wy, wx = (int(v) for v in kshape)
    wxp = -(-wx // 4) * 4

    def nbytes(stages, band, smem_taps):
        return 4 * ((wz * wy * wxp if smem_taps else 0)
                    + stages * (_WARPS + band - 1) * (_TX + wxp))
    if (wz, wy, wx) in COMPILED:
        return DensePlan(COMPILED[(wz, wy, wx)][0], nbytes(3, wy, True), 3,
                         wy, True)
    for band in range(wy, 0, -1):
        for smem_taps, stages in ((True, 3), (True, 2), (False, 3),
                                  (False, 2)):
            if nbytes(stages, band, smem_taps) <= SMEM_LIMIT:
                return DensePlan(0, nbytes(stages, band, smem_taps),
                                 stages, band, smem_taps)
    return None


def conv3d_dense_plain(x: torch.Tensor, kflip: torch.Tensor) -> torch.Tensor:
    """The twin: a sum of shifted copies of the zero-padded volume, one
    per tap, in the kernel's order."""
    kz, ky, kx = kflip.shape
    hz, hy, hx = kz // 2, ky // 2, kx // 2
    nz, ny, nx = x.shape
    xp = torch.nn.functional.pad(x, (hx, hx, hy, hy, hz, hz))
    out = torch.zeros_like(x)
    taps = kflip.tolist()
    for a in range(kz):
        for b in range(ky):
            for c in range(kx):
                out += xp[a:a + nz, b:b + ny, c:c + nx] * taps[a][b][c]
    return out


def conv3d_dense(x: torch.Tensor, kflip) -> torch.Tensor:
    """Dense correlation of a (Z, Y, X) float32 volume with the odd-sided
    (flipped) kernel ``kflip``.  A CPU tensor takes the plain twin; a
    CUDA tensor launches ``csrc/conv3d.cu`` as ``dense_plan`` says."""
    k = torch.as_tensor(kflip, dtype=torch.float32, device=x.device)
    if k.ndim != 3 or any(s % 2 == 0 for s in k.shape):
        raise ValueError(f"conv3d_dense takes an odd-sided 3-D kernel, got "
                         f"{tuple(k.shape)}")
    if x.device.type == "cpu":
        return conv3d_dense_plain(x, k)
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"conv3d_dense takes a (Z, Y, X) float32 CPU or "
                         f"CUDA tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    plan = dense_plan(k.shape)
    if plan is None:
        raise ValueError(f"conv3d_dense: a kernel row of {k.shape[2]} taps "
                         f"does not fit the kernel's shared memory")
    nz, ny, nx = x.shape
    tz = COMPILED[tuple(k.shape)][1] if plan.variant else _RUNTIME_TZ
    if -(-nz // tz) > 65535 or -(-ny // _WARPS) > 65535:
        raise ValueError(f"conv3d_dense: {tuple(x.shape)} exceeds the "
                         f"kernel's grid")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    wz, wy, wx = k.shape
    kp = torch.nn.functional.pad(k, (0, -wx % 4)).contiguous()
    with torch.cuda.device(x.device):
        cb.check(cb.library().visfd_conv3d(
            x.data_ptr(), out.data_ptr(), kp.data_ptr(), wx, wy, wz,
            nz, ny, nx, plan.variant, plan.smem, plan.stages, plan.band,
            int(plan.smem_taps), cb.stream_of(x)),
            "visfd_conv3d")
    conv3d_dense.launches += 1
    return out


conv3d_dense.launches = 0
