"""Dense stick tensor voting: the CUDA kernel (``csrc/tv.cu``), its
plain PyTorch twin, and the wrapper that picks one by the tensor's
device.

Port of ``visfd_tpu/ops/tv_pallas.py`` (``tv_dense_stick_pallas`` and
its per-shard entry ``tv_dense_stick_pallas_prepadded``, here
``tv_votes`` and ``tv_votes_prepadded``) and of the accumulation core of
``visfd_tpu/features/tv.py`` (``tv_tables``, ``tv_accumulate_padded``),
which is the kernel's twin.
Parity with ``class TV3D`` (``feature.hpp:1624-2483``): each receiver
gathers ``sal(s) * w(j) * mask(s) * angle^(p/2) * outer(n_rot, n_rot)``
from the sources s = i - j of the corner-truncated window of halfwidth
floor(sigma * ratio), where sin = n(s).rhat, angle = cos^2 for surfaces
and sin^2 for curves, and n_rot = 2 sin rhat - n (negated for curves).
The weights w come from the ``gen_gauss_kernel_3d`` table.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from visfd_tpu_torch import _cuda_build as cb
from visfd_tpu_torch.ops import kernels as K

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
# csrc/tv.cu's kMaxHw: a staged row's non-zero mask has 128 bits for its
# 32 + 2hw sources, and a thread reads its 2hw+1 of them as one word
_ROW_MASK_MAX_HW = 30


def smem_plan(hw: int, want_denominator: bool):
    """(tile rows, dynamic shared-memory bytes) of the voting kernel, or
    None when no tile fits: two staged planes of (rows + 2hw) x (32 +
    2hw) float4 sources (sal, n0, n1, n2), the float mask planes with
    the denominator, and each staged row's 128-bit non-zero mask for the
    plane being voted.  The rows are the most of 8, 4, 2, 1 that fit."""
    for rows in (8, 4, 2, 1):
        ry, sx = rows + 2 * hw, 32 + 2 * hw
        nbytes = 2 * ry * sx * (20 if want_denominator else 16) + ry * 16
        if nbytes <= SMEM_LIMIT:
            return rows, nbytes
    return None


# the largest window halfwidth the kernel takes, in every mode
MAX_KERNEL_HALFWIDTH = max(hw for hw in range(_ROW_MASK_MAX_HW + 1)
                           if smem_plan(hw, True) is not None)


def tv_tables(sigma: float, truncate_ratio: float = 2.5):
    """(radial weights (K,), unit displacements (K, 3) in (x, y, z),
    halfwidth), numpy float32, the K taps in (jz, jy, jx) raster order."""
    hw = int(np.floor(sigma * truncate_ratio))
    ker = K.gen_gauss_kernel_3d((sigma,) * 3, 2.0, (hw,) * 3)  # (Z, Y, X)
    jz, jy, jx = np.meshgrid(*([np.arange(-hw, hw + 1)] * 3), indexing="ij")
    offs = np.stack([jz.ravel(), jy.ravel(), jx.ravel()], axis=-1)
    w = ker.ravel().astype(np.float32)
    length = np.sqrt((offs ** 2).sum(axis=-1)).astype(np.float32)
    length[length == 0] = 1.0
    rhat = np.stack([offs[:, 2], offs[:, 1], offs[:, 0]],
                    axis=-1).astype(np.float32) / length[:, None]
    return w, rhat, hw


def tap_list(sigma: float, truncate_ratio: float = 2.5):
    """The compact tap list: the taps of non-zero weight, in the raster
    (jz, jy, jx) order of ``tv_tables``.  Returns (offsets (K, 3) int32
    as (dz, dy, dx) = (jz, jy, jx), weights (K,), unit displacements
    (K, 3) in (x, y, z), hw), the float32 entries of ``tv_tables``."""
    w, rhat, hw = tv_tables(sigma, truncate_ratio)
    keep = np.flatnonzero(w)
    w_len = 2 * hw + 1
    offs = np.stack(np.unravel_index(keep, (w_len,) * 3), axis=-1) - hw
    return offs.astype(np.int32), w[keep], rhat[keep], hw


def _kernel_tables(sigma: float, truncate_ratio: float):
    """(taps (K, 4) float32 rows (w, rx, ry, rz), meta int32, hw): what
    ``csrc/tv.cu`` reads.  meta holds, for the W = 2hw+1 tap planes tz:
    the compact index where each plane starts (W+1); a bitmask over the
    W x W raster window (ty, tx) of the taps of each plane, in 32-bit
    words (W x NW); the compact index of each word's first tap (W x NW);
    and each tap's offset in the staged plane from its receiver's
    source at (ty, tx) = (2hw, 2hw) (K)."""
    offs, w, rhat, hw = tap_list(sigma, truncate_ratio)
    w_len = 2 * hw + 1
    n_words = (w_len * w_len + 31) // 32
    tz, ty, tx = (offs + hw).T.astype(np.int64)
    pos = ty * w_len + tx
    pstart = np.searchsorted(tz, np.arange(w_len + 1))
    wmask = np.zeros((w_len, n_words), np.uint32)
    np.bitwise_or.at(wmask, (tz, pos // 32),
                     (np.uint32(1) << (pos % 32).astype(np.uint32)))
    key = tz * (32 * n_words) + pos
    starts = (np.arange(w_len)[:, None] * (32 * n_words)
              + 32 * np.arange(n_words)[None, :])
    wbase = np.searchsorted(key, starts.ravel())
    toff = (2 * hw - ty) * (32 + 2 * hw) + (2 * hw - tx)
    meta = np.concatenate([pstart, wmask.view(np.int32).ravel(), wbase,
                           toff]).astype(np.int32)
    taps = np.concatenate([w[:, None], rhat], axis=1).astype(np.float32)
    return taps, meta, hw


def tv_accumulate_padded(
    sal_pad, n_pad, m_pad, out_shape,
    w_table, rhat_table,
    exponent: int, detect_curves: bool, hw: int,
    want_denominator: bool,
):
    """The kernel's twin: vote accumulation over fields padded by hw on
    every face (sal_pad, m_pad (Z+2hw, Y+2hw, X+2hw); n_pad channel-last
    (..., 3)), the taps in the tables' raster order.  Returns (dest (Z,
    Y, X, 6), den (Z, Y, X))."""
    nz, ny, nx = out_shape
    w_len = 2 * hw + 1
    dev = sal_pad.device
    w_tz = torch.as_tensor(np.asarray(w_table), device=dev).reshape(
        w_len, w_len, w_len)
    rh_tz = torch.as_tensor(np.asarray(rhat_table), device=dev).reshape(
        w_len, w_len, w_len, 3)
    dest = torch.zeros((nz, ny, nx, 6), dtype=torch.float32, device=dev)
    den = torch.zeros((nz, ny, nx), dtype=torch.float32, device=dev)
    for tz in range(w_len):
        z0 = 2 * hw - tz  # = hw - jz
        acc = [torch.zeros((nz, ny, nx), dtype=torch.float32, device=dev)
               for _ in range(7)]
        for ty in range(w_len):
            for tx in range(w_len):
                y0 = 2 * hw - ty
                x0 = 2 * hw - tx
                sl = (slice(z0, z0 + nz), slice(y0, y0 + ny),
                      slice(x0, x0 + nx))
                sal = sal_pad[sl]
                m = m_pad[sl]
                n = n_pad[sl]
                w = w_tz[tz, ty, tx]
                rh = rh_tz[tz, ty, tx]

                filter_val = w * m
                active = (sal != 0.0) & (filter_val != 0.0)
                weight = torch.where(active, sal * filter_val, 0.0)

                sin_t = n[..., 0] * rh[0] + n[..., 1] * rh[1] + \
                    n[..., 2] * rh[2]
                sin2 = sin_t * sin_t
                ang2 = sin2 if detect_curves else 1.0 - sin2
                if exponent == 2:
                    decay_ang = ang2
                elif exponent == 4:
                    decay_ang = ang2 * ang2
                elif exponent % 2 == 0:
                    decay_ang = ang2 ** (exponent // 2)
                else:
                    decay_ang = torch.abs(ang2) ** (0.5 * exponent)
                sinx2 = 2.0 * sin_t
                if detect_curves:
                    nr = n - sinx2[..., None] * rh
                else:
                    nr = sinx2[..., None] * rh - n

                amp = weight * decay_ang
                acc[0] += amp * nr[..., 0] * nr[..., 0]
                acc[1] += amp * nr[..., 1] * nr[..., 1]
                acc[2] += amp * nr[..., 2] * nr[..., 2]
                acc[3] += amp * nr[..., 0] * nr[..., 1]
                acc[4] += amp * nr[..., 1] * nr[..., 2]
                acc[5] += amp * nr[..., 0] * nr[..., 2]
                if want_denominator:
                    acc[6] += torch.where(active, filter_val, 0.0)
        dest = dest + torch.stack(acc[:6], dim=-1)
        if want_denominator:
            den = den + acc[6]
    return dest, den


def _split_nvec(nvec, sal_shape, channel_major: Optional[bool]):
    """The direction field as one channel-major (3, Z, Y, X) tensor.
    Layout is (Z, Y, X, 3) or (3, Z, Y, X); ``None`` decides by shape
    but refuses the one ambiguous case, a 3x3x3 volume."""
    sal_shape = tuple(sal_shape)
    cm_ok = (nvec.ndim == 4 and nvec.shape[0] == 3
             and tuple(nvec.shape[1:]) == sal_shape)
    cl_ok = (nvec.ndim == 4 and nvec.shape[-1] == 3
             and tuple(nvec.shape[:-1]) == sal_shape)
    if channel_major is None:
        if cm_ok and cl_ok:
            raise ValueError("nvec layout is ambiguous for this shape; pass "
                             "nvec_channel_major explicitly")
        channel_major = cm_ok
    if channel_major:
        if not cm_ok:
            raise ValueError(f"expected channel-major (3,)+{sal_shape} nvec, "
                             f"got {tuple(nvec.shape)}")
        return nvec
    if not cl_ok:
        raise ValueError(f"expected {sal_shape}+(3,) nvec, got "
                         f"{tuple(nvec.shape)}")
    return torch.movedim(nvec, -1, 0)


def _tv_votes_prepadded_plain(sal_pad, nv_pad_cm, mask_pad, out_shape,
                              sigma, exponent, detect_curves, truncate_ratio,
                              want_denominator):
    """The twin of the per-shard mode: raw (6|7, Z, Y, X) channel-major
    vote accumulator over fields padded by hw on every face."""
    w, rhat, hw = tv_tables(sigma, truncate_ratio)
    m_pad = torch.ones_like(sal_pad) if mask_pad is None else mask_pad
    dest, den = tv_accumulate_padded(
        sal_pad, nv_pad_cm.movedim(0, -1), m_pad, tuple(out_shape), w, rhat,
        exponent, detect_curves, hw, want_denominator)
    chans = list(dest.unbind(-1)) + ([den] if want_denominator else [])
    return torch.stack(chans)


def _tv_votes_plain(sal, nv_cm, mask, sigma, exponent, detect_curves,
                    truncate_ratio, want_denominator):
    """The twin: raw (6|7, Z, Y, X) channel-major vote accumulator."""
    _, _, hw = tv_tables(sigma, truncate_ratio)
    pad = (hw,) * 6
    m = torch.ones_like(sal) if mask is None else mask
    return _tv_votes_prepadded_plain(
        torch.nn.functional.pad(sal, pad),
        torch.nn.functional.pad(nv_cm, pad),
        torch.nn.functional.pad(m, pad), sal.shape, sigma, exponent,
        detect_curves, truncate_ratio, want_denominator)


def tv_votes(
    saliency: torch.Tensor,       # (Z, Y, X) float32
    nvec: torch.Tensor,           # (Z, Y, X, 3) or (3, Z, Y, X)
    sigma: float,
    exponent: int = 4,
    mask_src: Optional[torch.Tensor] = None,
    detect_curves: bool = False,
    truncate_ratio: float = 2.5,
    want_denominator: bool = False,
    sparse: bool = False,
    channel_major: bool = False,
    nvec_channel_major: Optional[bool] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Raw (unnormalised) vote tensors (Z, Y, X, 6), or channel-major
    (6, Z, Y, X) with ``channel_major=True``, and the masked
    normalisation denominator (Z, Y, X) when ``want_denominator``.

    A CPU tensor takes the plain twin; a CUDA tensor launches
    ``csrc/tv.cu``.  ``sparse`` visits only the sources of non-zero
    saliency; it equals the dense mode bit for bit (the twin has no
    sparse mode: it would add the same zeros)."""
    exponent = int(exponent)
    nv = _split_nvec(nvec, saliency.shape, nvec_channel_major)
    if saliency.device.type == "cpu":
        sal = saliency.to(torch.float32)
        m = None if mask_src is None else mask_src.to(torch.float32)
        out = _tv_votes_plain(sal, nv.to(torch.float32), m, sigma, exponent,
                              bool(detect_curves), truncate_ratio,
                              bool(want_denominator))
    else:
        out = _tv_votes_cuda(tv_votes, "visfd_tv_votes", saliency, nv,
                             mask_src, saliency.shape, sigma, exponent,
                             bool(detect_curves), truncate_ratio,
                             bool(want_denominator), bool(sparse))
    return _split_votes(out, want_denominator, channel_major)


tv_votes.launches = 0


def _split_votes(out, want_denominator, channel_major):
    den = out[6] if want_denominator else None
    vote = out[:6] if channel_major else torch.movedim(out[:6], 0, -1)
    return vote, den


def tv_votes_prepadded(
    sal_pad: torch.Tensor,        # (Z+2hw, Y+2hw, X+2hw) float32
    nvec_pad: torch.Tensor,       # (3, Z+2hw, ...) or (Z+2hw, ..., 3)
    sigma: float,
    out_shape: Tuple[int, int, int],
    exponent: int = 4,
    mask_pad: Optional[torch.Tensor] = None,
    detect_curves: bool = False,
    truncate_ratio: float = 2.5,
    want_denominator: bool = False,
    sparse: bool = False,
    channel_major: bool = False,
    nvec_channel_major: Optional[bool] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-shard entry of a mesh run (``tv_dense_stick_pallas_
    prepadded``): voting over fields whose hw-deep halos the caller
    filled (neighbouring blocks' data, zeros beyond the global volume).
    ``mask_pad``, when given, is the haloed source mask (it gates votes
    and feeds the denominator).  Returns what ``tv_votes`` returns for
    the (Z, Y, X) = ``out_shape`` interior."""
    exponent = int(exponent)
    _, _, hw = tv_tables(sigma, truncate_ratio)
    out_shape = tuple(int(n) for n in out_shape)
    if tuple(sal_pad.shape) != tuple(n + 2 * hw for n in out_shape):
        raise ValueError(f"tv_votes_prepadded: fields {tuple(sal_pad.shape)}"
                         f" are not {out_shape} padded by hw={hw}")
    nv = _split_nvec(nvec_pad, sal_pad.shape, nvec_channel_major)
    if sal_pad.device.type == "cpu":
        m = None if mask_pad is None else mask_pad.to(torch.float32)
        out = _tv_votes_prepadded_plain(
            sal_pad.to(torch.float32), nv.to(torch.float32), m, out_shape,
            sigma, exponent, bool(detect_curves), truncate_ratio,
            bool(want_denominator))
    else:
        out = _tv_votes_cuda(tv_votes_prepadded, "visfd_tv_votes_prepadded",
                             sal_pad, nv, mask_pad, out_shape, sigma,
                             exponent,
                             bool(detect_curves), truncate_ratio,
                             bool(want_denominator), bool(sparse))
    return _split_votes(out, want_denominator, channel_major)


tv_votes_prepadded.launches = 0


def _tv_votes_cuda(wrapper, entry, saliency, nv_cm, mask_src, out_shape,
                   sigma, exponent, detect_curves, truncate_ratio,
                   want_denominator, sparse):
    """Launch the C ``entry`` on CUDA tensors (the fields are
    ``out_shape``, or ``out_shape`` padded by hw for the per-shard
    entry) and count the launch on ``wrapper``."""
    if (saliency.device.type != "cuda" or saliency.ndim != 3
            or nv_cm.device != saliency.device):
        raise ValueError(f"{wrapper.__name__} takes (Z, Y, X) CPU or CUDA "
                         f"tensors, got {tuple(saliency.shape)} on "
                         f"{saliency.device}, nvec on {nv_cm.device}")
    taps, meta, hw = _kernel_tables(sigma, truncate_ratio)
    if hw > MAX_KERNEL_HALFWIDTH:
        raise ValueError(f"{wrapper.__name__}: window halfwidth {hw} "
                         f"exceeds the kernel's {MAX_KERNEL_HALFWIDTH}")
    rows, smem = smem_plan(hw, want_denominator)
    dev = saliency.device
    sal = saliency.to(torch.float32)
    md = None
    if mask_src is not None:
        md = mask_src.to(device=dev, dtype=torch.float32).contiguous()
        sal = sal * md  # the vote weight factorises (feature.hpp:2262)
    sal = sal.contiguous()
    if want_denominator and md is None:
        md = torch.ones_like(sal)
    nv_cm = nv_cm.to(torch.float32).contiguous()
    taps = torch.as_tensor(taps, device=dev)
    meta = torch.as_tensor(meta, device=dev)
    nz, ny, nx = out_shape
    out = torch.empty((7 if want_denominator else 6, nz, ny, nx),
                      dtype=torch.float32, device=dev)
    if out.numel():
        with torch.cuda.device(dev):
            cb.check(getattr(cb.library(), entry)(
                sal.data_ptr(), nv_cm.data_ptr(),
                md.data_ptr() if want_denominator else None,
                taps.data_ptr(), meta.data_ptr(), out.data_ptr(), nz, ny,
                nx, hw, rows, smem, exponent, int(detect_curves),
                int(want_denominator), int(sparse), cb.stream_of(sal)),
                entry)
        wrapper.launches += 1
    return out
