// Dense stick tensor voting by gather, with an optional sparse mode.
//
// Replaces: visfd_tpu/ops/tv_pallas.py, _tv_kernel (pallas_call in
// _tv_pallas_one_call, driven by _tv_pallas_padded_core; entries
// tv_dense_stick_pallas and, for the blocks of a -mesh run,
// tv_dense_stick_pallas_prepadded).  Each receiver sums, over the
// corner-truncated
// window of (2hw+1)^3 sources s = receiver - j, the stick vote
//   sal(s) w(j) ang^(e/2) r r^T,  sin = n(s).rhat, ang = 1 - sin^2
//   (curves: sin^2), r = 2 sin rhat - n(s) (curves: negated),
// with w(j) and rhat = j/|j| from the tap table the wrapper builds from
// the same gen_gauss_kernel_3d table as the TPU kernel (a recomputed exp
// disagreed with it on the hw=3 corner shell).  The mask is folded into
// sal by the wrapper; the optional 7th channel is sum(s != 0 ? w m : 0).
//
// What bounds it on an H100: float32 arithmetic.  A receiver does ~35
// operations for each of the (2hw+1)^3 taps (343 at hw=3, ~12,000
// operations), against 16 bytes of fields read and 24-28 bytes written
// per voxel.
//
// Design: a block is a 32 x 8 tile of receivers in one z plane, one
// thread per receiver, its 6 or 7 sums in registers.  The block walks
// the 2hw+1 source planes; for each it stages the haloed tile of the
// saliency and of the three direction components (and the mask) in
// shared memory, zero outside the volume, then every thread runs the
// (2hw+1)^2 in-plane taps from shared memory.  Taps of zero weight
// (the truncated corners) are skipped; the tap table is read through
// the read-only cache, the same entry by every thread (a broadcast).
//
// Prepadded mode (the per-shard entry): the fields are (nz+2hw, ny+2hw,
// nx+2hw) with hw-deep halos the caller filled (neighbouring blocks'
// data, zeros beyond the global volume), and the receiver (z, y, x)
// sits at (z+hw, y+hw, x+hw).  The only difference is where a tile is
// staged from, so each receiver sums the same taps in the same order;
// a halo plane beyond the volume adds exact zeros where the
// single-device mode skips the plane, which leaves every sum unchanged.
//
// Sparse mode (the -tv-best default): __syncthreads_or tells the block
// whether its staged saliency tile of a source plane holds any non-zero
// value; if not, the plane's taps and its direction and mask loads are
// skipped.  That is the TPU kernel's per-(block, source plane) predicate.
// A skipped plane would add exact zeros, and both modes run the same
// code in the same tap order, so sparse equals dense bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

__global__ void tv_votes_kernel(const float* __restrict__ sal,
                                const float* __restrict__ nvec,
                                const float* __restrict__ mask,
                                const float4* __restrict__ taps,
                                float* __restrict__ out, int nz, int ny,
                                int nx, int hw, int exponent, bool curves,
                                bool want_den, bool sparse, int off) {
  extern __shared__ float smem[];
  const int wl = 2 * hw + 1;
  const int sx = kTileX + 2 * hw;
  const int plane = (kTileY + 2 * hw) * sx;
  float* s_sal = smem;
  float* s_n0 = smem + plane;
  float* s_n1 = smem + 2 * plane;
  float* s_n2 = smem + 3 * plane;
  float* s_m = smem + 4 * plane;  // only with want_den

  const int lx = threadIdx.x, ly = threadIdx.y;
  const int tid = ly * kTileX + lx;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const int z = blockIdx.z;
  const int x = x0 + lx, y = y0 + ly;
  const int64_t nplane = static_cast<int64_t>(ny) * nx;
  const int64_t nvox = nplane * nz;
  const bool live = x < nx && y < ny;
  // the fields: (fz, fy, fx), receiver (z, y, x) at (z, y, x) + off
  const int fz = nz + 2 * off, fy = ny + 2 * off, fx = nx + 2 * off;
  const int64_t fplane = static_cast<int64_t>(fy) * fx;
  const int64_t fvox = fplane * fz;

  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int tz = 0; tz < wl; ++tz) {
    const int zs = z - (tz - hw) + off;  // source plane of tap row tz
    if (zs < 0 || zs >= fz) continue;  // uniform over the block
    const int64_t pbase = zs * fplane;

    int nonzero = 0;
    for (int e = tid; e < plane; e += kTileX * kTileY) {
      const int gy = y0 - hw + off + e / sx, gx = x0 - hw + off + e % sx;
      float v = 0.f;
      if (gy >= 0 && gy < fy && gx >= 0 && gx < fx) {
        v = sal[pbase + static_cast<int64_t>(gy) * fx + gx];
      }
      s_sal[e] = v;
      nonzero |= (v != 0.f);
    }
    // barrier: the saliency tile is complete before anyone reads it
    const int occupied = __syncthreads_or(nonzero);
    if (sparse && !occupied) continue;  // uniform over the block

    for (int e = tid; e < plane; e += kTileX * kTileY) {
      const int gy = y0 - hw + off + e / sx, gx = x0 - hw + off + e % sx;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, m = 0.f;
      if (gy >= 0 && gy < fy && gx >= 0 && gx < fx) {
        const int64_t g = pbase + static_cast<int64_t>(gy) * fx + gx;
        a0 = nvec[g];
        a1 = nvec[fvox + g];
        a2 = nvec[2 * fvox + g];
        if (want_den) m = mask[g];
      }
      s_n0[e] = a0;
      s_n1[e] = a1;
      s_n2[e] = a2;
      if (want_den) s_m[e] = m;
    }
    __syncthreads();

    if (live) {
      for (int ty = 0; ty < wl; ++ty) {
        for (int tx = 0; tx < wl; ++tx) {
          const float4 tap = __ldg(&taps[(tz * wl + ty) * wl + tx]);
          const float w = tap.x;
          if (w == 0.f) continue;  // corner-truncated tap
          const float rx = tap.y, ry = tap.z, rz = tap.w;
          // source (y - jy, x - jx), jy = ty - hw, jx = tx - hw
          const int e = (ly + 2 * hw - ty) * sx + (lx + 2 * hw - tx);
          const float s = s_sal[e];
          const float a0 = s_n0[e], a1 = s_n1[e], a2 = s_n2[e];
          const float sin_t = a0 * rx + a1 * ry + a2 * rz;
          const float sin2 = sin_t * sin_t;
          const float ang2 = curves ? sin2 : 1.0f - sin2;
          float dec;
          if (exponent % 2 == 0) {
            dec = 1.0f;
            for (int k = 0; k < exponent / 2; ++k) dec *= ang2;
          } else {
            dec = powf(fabsf(ang2), 0.5f * exponent);
          }
          const float sx2 = 2.0f * sin_t;
          float r0, r1, r2;
          if (curves) {
            r0 = a0 - sx2 * rx;
            r1 = a1 - sx2 * ry;
            r2 = a2 - sx2 * rz;
          } else {
            r0 = sx2 * rx - a0;
            r1 = sx2 * ry - a1;
            r2 = sx2 * rz - a2;
          }
          const float amp = s * (w * dec);
          const float p0 = amp * r0, p1 = amp * r1, p2 = amp * r2;
          acc[0] += p0 * r0;
          acc[1] += p1 * r1;
          acc[2] += p2 * r2;
          acc[3] += p0 * r1;
          acc[4] += p1 * r2;
          acc[5] += p0 * r2;
          if (want_den) acc[6] += (s != 0.f) ? w * s_m[e] : 0.f;
        }
      }
    }
    // barrier: everyone is done with this plane's tiles
    __syncthreads();
  }

  if (live) {
    const int64_t i = z * nplane + static_cast<int64_t>(y) * nx + x;
    const int n_acc = want_den ? 7 : 6;
#pragma unroll
    for (int c = 0; c < 7; ++c) {  // unrolled: acc stays in registers
      if (c < n_acc) out[c * nvox + i] = acc[c];
    }
  }
}

int launch_tv(const void* sal, const void* nvec, const void* mask,
              const void* taps, void* out, int nz, int ny, int nx, int hw,
              int exponent, int curves, int want_den, int sparse, int off,
              void* stream) {
  const int n_fields = want_den ? 5 : 4;
  const size_t smem = sizeof(float) * n_fields * (kTileY + 2 * hw) *
                      (kTileX + 2 * hw);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tv_votes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(kTileX, kTileY);
  const dim3 grid((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY,
                  nz);
  tv_votes_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sal), static_cast<const float*>(nvec),
      static_cast<const float*>(mask), static_cast<const float4*>(taps),
      static_cast<float*>(out), nz, ny, nx, hw, exponent, curves != 0,
      want_den != 0, sparse != 0, off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (nz, ny, nx) is the output's shape in both entries; the prepadded
// fields are (nz+2hw, ny+2hw, nx+2hw).
extern "C" int visfd_tv_votes(const void* sal, const void* nvec,
                              const void* mask, const void* taps, void* out,
                              int nz, int ny, int nx, int hw, int exponent,
                              int curves, int want_den, int sparse,
                              void* stream) {
  return launch_tv(sal, nvec, mask, taps, out, nz, ny, nx, hw, exponent,
                   curves, want_den, sparse, 0, stream);
}

extern "C" int visfd_tv_votes_prepadded(
    const void* sal_pad, const void* nvec_pad, const void* mask_pad,
    const void* taps, void* out, int nz, int ny, int nx, int hw,
    int exponent, int curves, int want_den, int sparse, void* stream) {
  return launch_tv(sal_pad, nvec_pad, mask_pad, taps, out, nz, ny, nx, hw,
                   exponent, curves, want_den, sparse, hw, stream);
}
