// Stick tensor voting by gather: dense, and sparse at the granularity of
// the source.
//
// Replaces: visfd_tpu/ops/tv_pallas.py, _tv_kernel (pallas_call in
// _tv_pallas_one_call, driven by _tv_pallas_padded_core; entries
// tv_dense_stick_pallas and, for the blocks of a -mesh run,
// tv_dense_stick_pallas_prepadded).  Each receiver sums, over the
// non-zero-weight taps j of the corner-truncated window of halfwidth hw,
// the stick vote of the source s = receiver - j:
//   sal(s) w(j) ang^(e/2) r r^T,  sin = n(s).rhat, ang = 1 - sin^2
//   (curves: sin^2), r = 2 sin rhat - n(s)
// (curves negate r, which leaves r r^T unchanged bit for bit).  w and
// rhat = j/|j| come from the compact tap list the wrapper builds from
// the gen_gauss_kernel_3d table (never a recomputed exp).  The mask is
// folded into sal by the wrapper; the optional 7th channel is
// sum(s != 0 ? w m : 0).
//
// What bounds it on an H100: instruction issue.  A tap costs ~20 float32
// instructions per (receiver, non-zero source) pair; the fields are 16-20
// bytes per voxel read and 24-28 written.  Under -tv-best 0.05 only 5%
// of the sources are non-zero, so the work that is needed scales with
// the non-zero sources, and the design's aim is to do only that work.
//
// Design.  A block is a 32 x by tile of (y, x) receiver columns, one
// thread per column, and each thread owns kTZ receivers of its column
// (a z brick), their 6|7 sums in registers.  The block stages the
// source planes of the brick one at a time, from the highest z down,
// each once, as (sal, n0, n1, n2) float4s (and the mask) with a haloed
// (by + 2hw) x (32 + 2hw) footprint, zero outside the volume; cp.async
// double-buffers them, so plane p + 1 arrives while p computes.  For a
// staged plane, each receiver of the brick within reach adds the taps
// of its tap plane tz = z - zs + hw:
//   dense: every tap of that plane of the compact list, in list order;
//   sparse: a __ballot_sync bitmask of the non-zero saliencies of every
//   staged row (bit-reversed, so that bits run with tx); each thread
//   gathers its (2hw+1)^2 window of it once per plane into a raster
//   bitmap, ANDs it with the tap plane's weight mask and walks the set
//   bits (ffs), so a thread touches only non-zero sources.  A plane
//   without a non-zero source in the block's footprint is skipped by
//   the whole block (__syncthreads_or).
// hw 1-8 are compile-time instantiations (the window bitmap in
// registers); one runtime-hw instantiation of the same code serves hw 0
// and 9 up to the cap the wrapper computes from the shared-memory plan.
// The exponent (with fast paths for 2 and 4) and curves stay runtime
// values, uniform over the launch, which keeps the build at 18
// instantiations.  The tap tables are read through the read-only cache,
// not constant memory: the sparse walk reads a different tap in each
// lane, which constant memory would serialise.
//
// Invariants.  Every receiver adds the same non-zero contributions in
// the same order in every mode: planes by descending source z (that is
// ascending tz), within a plane the compact list's raster order.  The
// sparse walk and the dense loop call one inline function written with
// round-to-nearest intrinsics, so no contraction differs between them.
// A skipped source would add an exact zero (sal = 0: amp = 0, products
// +-0, and an accumulator that starts at +0 is never -0), and a plane
// beyond the volume that the single-device mode skips is a plane of
// zeros in the prepadded mode, so sparse == dense and prepadded ==
// single-device, bit for bit.
//
// Prepadded mode (the per-shard entry): the fields are (nz+2hw, ny+2hw,
// nx+2hw) with hw-deep halos the caller filled, and the receiver
// (z, y, x) sits at (z+hw, y+hw, x+hw); only the staging offset differs.

#include <cuda_runtime.h>
#include <cstdint>

#include "cp_async.cuh"

namespace {

using visfd::cp_async4;
using visfd::cp_async_commit;
using visfd::cp_async_wait;

constexpr int kTileX = 32;
// receivers per thread along z: 4 beat 2, 8 and 16 on the card (fewer
// planes staged per receiver against more blocks in flight)
constexpr int kTZ = 4;
constexpr int kMaxHw = 30;        // the 128-bit staged row holds 32 + 2hw
constexpr int kMaxWinWords = ((2 * kMaxHw + 1) * (2 * kMaxHw + 1) + 31) / 32;

struct Acc {
  float v[7];
};

// One stick vote into acc, every operation rounded on its own.
template <bool DEN>
__device__ __forceinline__ void vote(Acc& acc, const float4 src, float m,
                                     const float4 tap, int exponent,
                                     bool curves) {
  const float s = src.x, a0 = src.y, a1 = src.z, a2 = src.w;
  const float w = tap.x, rx = tap.y, ry = tap.z, rz = tap.w;
  const float sin_t = __fmaf_rn(a2, rz, __fmaf_rn(a1, ry, __fmul_rn(a0, rx)));
  const float sin2 = __fmul_rn(sin_t, sin_t);
  const float ang2 = curves ? sin2 : __fsub_rn(1.0f, sin2);
  float dec;
  if (exponent == 4) {
    dec = __fmul_rn(ang2, ang2);
  } else if (exponent == 2) {
    dec = ang2;
  } else if (exponent % 2 == 0) {
    dec = 1.0f;
    for (int k = 0; k < exponent / 2; ++k) dec = __fmul_rn(dec, ang2);
  } else {
    dec = powf(fabsf(ang2), 0.5f * exponent);
  }
  const float sx2 = __fmul_rn(2.0f, sin_t);
  const float r0 = __fmaf_rn(sx2, rx, -a0);
  const float r1 = __fmaf_rn(sx2, ry, -a1);
  const float r2 = __fmaf_rn(sx2, rz, -a2);
  const float amp = __fmul_rn(s, __fmul_rn(w, dec));
  const float p0 = __fmul_rn(amp, r0), p1 = __fmul_rn(amp, r1),
              p2 = __fmul_rn(amp, r2);
  acc.v[0] = __fmaf_rn(p0, r0, acc.v[0]);
  acc.v[1] = __fmaf_rn(p1, r1, acc.v[1]);
  acc.v[2] = __fmaf_rn(p2, r2, acc.v[2]);
  acc.v[3] = __fmaf_rn(p0, r1, acc.v[3]);
  acc.v[4] = __fmaf_rn(p1, r2, acc.v[4]);
  acc.v[5] = __fmaf_rn(p0, r2, acc.v[5]);
  if (DEN) acc.v[6] = __fadd_rn(acc.v[6], s != 0.0f ? __fmul_rn(w, m) : 0.0f);
}

// meta (int32): [tap-plane starts (W+1)] [weight masks (W x NW), bit b of
// word k = raster window position 32k + b] [compact index of the first
// tap of each mask word (W x NW)] [staged offset of every tap (K)].
// HW > 0: compile-time halfwidth; HW == 0: runtime hw_rt.
template <int HW, bool DEN>
__global__ void __launch_bounds__(256)
    tv_votes_kernel(const float* __restrict__ sal,
                    const float* __restrict__ nvec,
                    const float* __restrict__ mask,
                    const float4* __restrict__ taps,
                    const int* __restrict__ meta, float* __restrict__ out,
                    int nz, int ny, int nx, int hw_rt, int exponent,
                    int curves_i, int sparse_i, int off) {
  const int hw = HW > 0 ? HW : hw_rt;
  const int W = 2 * hw + 1;
  constexpr int kWords = HW > 0 ? ((2 * HW + 1) * (2 * HW + 1) + 31) / 32
                                : kMaxWinWords;
  const int NW = HW > 0 ? kWords : (W * W + 31) / 32;
  const bool curves = curves_i != 0, sparse = sparse_i != 0;
  const int by = blockDim.y;
  const int RY = by + 2 * hw, SX = kTileX + 2 * hw;
  const int plane = RY * SX;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* buf = reinterpret_cast<float4*>(smem_raw);     // [2][plane]
  float* mbuf = reinterpret_cast<float*>(buf + 2 * plane);  // [2][plane]
  unsigned long long* rm = reinterpret_cast<unsigned long long*>(
      mbuf + (DEN ? 2 * plane : 0));                    // [RY][lo, hi]

  const int* pstart = meta;
  const unsigned* wmask = reinterpret_cast<const unsigned*>(meta + W + 1);
  const int* wbase = meta + W + 1 + W * NW;
  const int* toff = wbase + W * NW;

  const int lx = threadIdx.x, ly = threadIdx.y;
  const int tid = ly * kTileX + lx, nthreads = kTileX * by;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * by;
  const int z0 = blockIdx.z * kTZ;
  const int fz = nz + 2 * off, fy = ny + 2 * off, fx = nx + 2 * off;
  const int64_t fplane = static_cast<int64_t>(fy) * fx;
  const int64_t fvox = fplane * fz;
  const int lane_base = ly * SX + lx;

  // source planes, receiver coordinates, highest first; the fields hold
  // zs in [-off, nz - 1 + off]
  const int z_hi = min(z0 + kTZ - 1 + hw, nz - 1 + off);
  const int z_lo = max(z0 - hw, -off);

  auto stage = [&](int zs, int b) {
    const int64_t pbase = static_cast<int64_t>(zs + off) * fplane;
    float* dst = reinterpret_cast<float*>(buf + b * plane);
    float* mdst = mbuf + b * plane;
    for (int e = tid; e < plane; e += nthreads) {
      const int r = e / SX, c = e - r * SX;
      const int gy = y0 - hw + off + r, gx = x0 - hw + off + c;
      const bool ok = gy >= 0 && gy < fy && gx >= 0 && gx < fx;
      const int64_t g = ok ? pbase + static_cast<int64_t>(gy) * fx + gx : 0;
      cp_async4(dst + 4 * e, sal + g, ok);
      cp_async4(dst + 4 * e + 1, nvec + g, ok);
      cp_async4(dst + 4 * e + 2, nvec + fvox + g, ok);
      cp_async4(dst + 4 * e + 3, nvec + 2 * fvox + g, ok);
      if (DEN) cp_async4(mdst + e, mask + g, ok);
    }
    cp_async_commit();
  };

  Acc acc[kTZ];
#pragma unroll
  for (int i = 0; i < kTZ; ++i) {
#pragma unroll
    for (int c = 0; c < 7; ++c) acc[i].v[c] = 0.0f;
  }

  if (z_hi >= z_lo) stage(z_hi, 0);
  int b = 0;
  for (int zs = z_hi; zs >= z_lo; --zs, b ^= 1) {
    // barrier: every thread is done with plane zs + 1, whose buffer
    // plane zs - 1 now fills
    __syncthreads();
    if (zs > z_lo) {
      stage(zs - 1, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const float4* cur = buf + b * plane;
    const float* mcur = mbuf + b * plane;
    int any = 1;
    if (sparse) {
      // barrier: this plane's copies of every thread have landed (and
      // every thread is done with the last plane's row masks)
      __syncthreads();
      any = 0;
      for (int r = ly; r < RY; r += by) {  // a warp per staged row
        unsigned bal[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int c = j * 32 + lx;
          bal[j] = __ballot_sync(0xffffffffu,
                                 c < SX && cur[r * SX + c].x != 0.0f);
        }
        // bit 127 - c <-> staged column c
        const unsigned long long hi =
            (static_cast<unsigned long long>(__brev(bal[0])) << 32) |
            __brev(bal[1]);
        const unsigned long long lo =
            static_cast<unsigned long long>(__brev(bal[2])) << 32;
        if (lx == 0) {
          rm[2 * r] = lo;
          rm[2 * r + 1] = hi;
        }
        any |= (hi | lo) != 0;
      }
    }
    // barrier: the plane (and its row masks) are complete; in sparse
    // mode a plane with no non-zero source in the footprint is skipped
    if (!__syncthreads_or(any)) continue;

    unsigned win[kWords];
    if (sparse) {
      // this thread's (2hw+1)^2 window of non-zero sources, raster
      // (ty, tx) order: bit 32k + b of win <-> position 32k + b
#pragma unroll
      for (int k = 0; k < (HW > 0 ? kWords : NW); ++k) win[k] = 0u;
      const int p = 127 - lx - 2 * hw;  // row bit of tx = 0
#pragma unroll
      for (int ty = 0; ty < (HW > 0 ? 2 * HW + 1 : W); ++ty) {
        const int r = ly + 2 * hw - ty;
        const unsigned long long lo = rm[2 * r], hi = rm[2 * r + 1];
        unsigned long long f;
        if ((HW > 0 && HW <= 16) || p >= 64) {
          f = hi >> (p - 64);
        } else {
          f = (lo >> p) | (hi << (64 - p));
        }
        if (W < 64) f &= (1ull << W) - 1ull;
        const int o = ty * W, wi = o >> 5, sh = o & 31;
        const unsigned long long part = f << sh;
        win[wi] |= static_cast<unsigned>(part);
        if (wi + 1 < NW) win[wi + 1] |= static_cast<unsigned>(part >> 32);
        if (sh != 0 && W + sh > 64 && wi + 2 < NW) {
          win[wi + 2] |= static_cast<unsigned>(f >> (64 - sh));
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kTZ; ++i) {
      const int tz = z0 + i - zs + hw;  // uniform over the block
      if (tz < 0 || tz >= W) continue;
      if (!sparse) {
        const int k_end = __ldg(pstart + tz + 1);
        for (int k = __ldg(pstart + tz); k < k_end; ++k) {
          const int e = lane_base + __ldg(toff + k);
          vote<DEN>(acc[i], cur[e], DEN ? mcur[e] : 0.0f, __ldg(taps + k),
                    exponent, curves);
        }
        continue;
      }
#pragma unroll
      for (int wd = 0; wd < (HW > 0 ? kWords : NW); ++wd) {
        const unsigned tm = __ldg(wmask + tz * NW + wd);
        unsigned bits = tm & win[wd];
        if (!__any_sync(0xffffffffu, bits != 0u)) continue;
        const int k0 = __ldg(wbase + tz * NW + wd);
        while (bits) {
          const int bit = __ffs(bits) - 1;
          bits &= bits - 1u;
          const int k = k0 + __popc(tm & ((1u << bit) - 1u));
          const int e = lane_base + __ldg(toff + k);
          vote<DEN>(acc[i], cur[e], DEN ? mcur[e] : 0.0f, __ldg(taps + k),
                    exponent, curves);
        }
      }
    }
  }

  const int x = x0 + lx, y = y0 + ly;
  if (x >= nx || y >= ny) return;
  const int64_t nplane = static_cast<int64_t>(ny) * nx;
  const int64_t nvox = nplane * nz;
#pragma unroll
  for (int i = 0; i < kTZ; ++i) {
    const int z = z0 + i;
    if (z >= nz) break;
    const int64_t idx = z * nplane + static_cast<int64_t>(y) * nx + x;
#pragma unroll
    for (int c = 0; c < (DEN ? 7 : 6); ++c) out[c * nvox + idx] = acc[i].v[c];
  }
}

template <int HW, bool DEN>
int launch(const void* sal, const void* nvec, const void* mask,
           const void* taps, const void* meta, void* out, int nz, int ny,
           int nx, int hw, int by, int smem, int exponent, int curves,
           int sparse, int off, cudaStream_t stream) {
  auto kernel = tv_votes_kernel<HW, DEN>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(kTileX, by);
  const dim3 grid((nx + kTileX - 1) / kTileX, (ny + by - 1) / by,
                  (nz + kTZ - 1) / kTZ);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const float*>(sal), static_cast<const float*>(nvec),
      static_cast<const float*>(mask), static_cast<const float4*>(taps),
      static_cast<const int*>(meta), static_cast<float*>(out), nz, ny, nx,
      hw, exponent, curves, sparse, off);
  return static_cast<int>(cudaGetLastError());
}

template <bool DEN>
int dispatch(const void* sal, const void* nvec, const void* mask,
             const void* taps, const void* meta, void* out, int nz, int ny,
             int nx, int hw, int by, int smem, int exponent, int curves,
             int sparse, int off, cudaStream_t stream) {
#define VISFD_TV_CASE(H)                                                   \
  case H:                                                                  \
    return launch<H, DEN>(sal, nvec, mask, taps, meta, out, nz, ny, nx,    \
                          hw, by, smem, exponent, curves, sparse, off,     \
                          stream);
  switch (hw) {
    VISFD_TV_CASE(1)
    VISFD_TV_CASE(2)
    VISFD_TV_CASE(3)
    VISFD_TV_CASE(4)
    VISFD_TV_CASE(5)
    VISFD_TV_CASE(6)
    VISFD_TV_CASE(7)
    VISFD_TV_CASE(8)
    default:
      if (hw < 0 || hw > kMaxHw) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      return launch<0, DEN>(sal, nvec, mask, taps, meta, out, nz, ny, nx,
                            hw, by, smem, exponent, curves, sparse, off,
                            stream);
  }
#undef VISFD_TV_CASE
}

int launch_tv(const void* sal, const void* nvec, const void* mask,
              const void* taps, const void* meta, void* out, int nz, int ny,
              int nx, int hw, int by, int smem, int exponent, int curves,
              int want_den, int sparse, int off, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return want_den ? dispatch<true>(sal, nvec, mask, taps, meta, out, nz, ny,
                                   nx, hw, by, smem, exponent, curves,
                                   sparse, off, s)
                  : dispatch<false>(sal, nvec, mask, taps, meta, out, nz,
                                    ny, nx, hw, by, smem, exponent, curves,
                                    sparse, off, s);
}

}  // namespace

// (nz, ny, nx) is the output's shape in both entries; the prepadded
// fields are (nz+2hw, ny+2hw, nx+2hw).  taps (K float4) and meta come
// from ops/tv_cuda._tap_plan, by and smem from ops/tv_cuda.smem_plan.
extern "C" int visfd_tv_votes(const void* sal, const void* nvec,
                              const void* mask, const void* taps,
                              const void* meta, void* out, int nz, int ny,
                              int nx, int hw, int by, int smem, int exponent,
                              int curves, int want_den, int sparse,
                              void* stream) {
  return launch_tv(sal, nvec, mask, taps, meta, out, nz, ny, nx, hw, by,
                   smem, exponent, curves, want_den, sparse, 0, stream);
}

extern "C" int visfd_tv_votes_prepadded(
    const void* sal_pad, const void* nvec_pad, const void* mask_pad,
    const void* taps, const void* meta, void* out, int nz, int ny, int nx,
    int hw, int by, int smem, int exponent, int curves, int want_den,
    int sparse, void* stream) {
  return launch_tv(sal_pad, nvec_pad, mask_pad, taps, meta, out, nz, ny, nx,
                   hw, by, smem, exponent, curves, want_den, sparse, hw,
                   stream);
}
