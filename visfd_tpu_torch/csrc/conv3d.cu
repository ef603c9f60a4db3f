// Dense (non-separable) 3-D correlation with zero padding.
//
// Replaces: visfd_tpu/ops/conv.py, _dense_conv3d_impl (XLA's
// conv_general_dilated at Precision.HIGHEST; no Pallas kernel), which
// the generalized Gaussians (-ggauss, -dogg), -fluct with an exponent
// other than 2, -template-gauss and -doggxy's 2-D pass run.  The wrapper
// (ops/dense_cuda.py) passes the kernel already flipped, each row padded
// to a multiple of 4 taps, so out[z, y, x] = sum over (a, b, c) of
// k[a, b, c] * in[z - hz + a, y - hy + b, x - hx + c], samples outside
// the volume zero.
//
// What bounds it on an H100: operations, 2 per tap (one FMA): a 31^3
// kernel is 59,582 operations a voxel against 8 bytes moved.  So the
// design feeds the FMA units from registers and spends as few other
// instructions as it can on each FMA.
//
// Design.  A block of 8 warps owns an output tile of TZ planes by 8 rows
// (one a warp) by 128 columns (4 adjacent ones a lane).  It marches in
// z over the TZ + wz - 1 input planes the tile needs; cp.async keeps
// kStages - 1 of them in flight into a ring of shared-memory stages,
// each the plane's haloed footprint (8 + wy - 1 rows of 128 + wx
// columns, rounded up to 4), with zeros outside the volume, so the
// inner loop has no bounds test.  For each staged plane and kernel row
// b a thread loads the row segment its 4 outputs read (4 + wx - 1
// samples, as float4s) into registers once, and applies every tap c of
// row b of every kernel plane a = zi - z + hz the input plane reaches,
// to all 4 outputs of each of the TZ output planes: 4 TZ' wx FMAs for
// (4 + wx - 1) / 4 + TZ' wx / 4 shared loads.  The taps are read as
// warp-uniform float4 broadcasts from shared memory (the whole padded
// kernel: 123 KB at 31^3), or through L1 where a runtime kernel does not
// fit beside the stages.  The widths the CLI launches are compiled as
// such (3^3, 5^3, 7^3, 15^3, (1, 21, 21), 31^3: the segment and the
// taps of a row unrolled in registers); one runtime instance takes every
// other shape, the segment walked 4 columns at a time, and kernels whose
// rows do not fit in one stage are staged a band of rows at a time.
// ops/dense_cuda.dense_plan chooses the instance (and with it TZ), the
// stages, the band and the shared bytes.
//
// Invariant: every output starts at 0.0f and adds fmaf(k[a][b][c],
// sample, acc) in ascending (a, b, c) order, the planes marched in
// ascending z, rows in ascending b, taps in ascending c; samples outside
// the volume enter as zeros through the same FMA.  The order depends on
// nothing but the kernel, so the outputs equal the one-output-a-thread
// kernel this replaces bit for bit, and a -mesh block read with a halo
// at least the kernel's halfwidths deep gives its interior the
// single-device bits.

#include <cuda_runtime.h>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // output rows a tile, one a warp
constexpr int kRx = 4;                 // adjacent outputs a lane
constexpr int kTX = 32 * kRx;          // output columns a tile

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// WX > 0: a compiled (WZ, WY, WX) kernel with its taps in shared memory;
// WX == 0: the runtime instance.  TZ output planes a block.
template <int WZ, int WY, int WX, int TZ, bool kSmemTaps>
__global__ void __launch_bounds__(kThreads)
    conv3d_kernel(const float* __restrict__ in, float* __restrict__ out,
                  const float* __restrict__ taps, int wz_rt, int wy_rt,
                  int wx_rt, int nz, int ny, int nx, int band_rt,
                  int stages) {
  constexpr bool kFixed = WX > 0;
  static_assert(!kFixed || kSmemTaps, "compiled widths stage their taps");
  const int wz = kFixed ? WZ : wz_rt, wy = kFixed ? WY : wy_rt;
  const int wx = kFixed ? WX : wx_rt;
  const int hz = wz / 2, hy = wy / 2, hx = wx / 2;
  const int wxp = (wx + 3) & ~3;        // a padded kernel row
  const int sx = kTX + wxp;             // a staged row (floats)
  const int band = kFixed ? WY : band_rt;   // kernel rows a staged unit
  const int nbands = (wy + band - 1) / band;
  const int rows = kWarps + band - 1;   // staged rows a unit
  const int unit = rows * sx;
  const int ntaps = wz * wy * wxp;

  extern __shared__ __align__(16) float sm[];
  float* s_taps = sm;
  float* s_in = sm + (kSmemTaps ? ntaps : 0);   // ntaps % 4 == 0

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kWarps;
  const int z0 = blockIdx.z * TZ;
  const int nz_out = min(TZ, nz - z0);  // output planes of this block
  const int n_units = (nz_out + wz - 1) * nbands;
  const int64_t plane = static_cast<int64_t>(ny) * nx;

  // unit u: input plane z0 - hz + u / nbands, kernel rows from
  // (u % nbands) * band; one cp.async group a unit (empty past the end)
  auto stage = [&](int u) {
    if (u < n_units) {
      const int zi = z0 - hz + u / nbands;
      const int b0 = (u % nbands) * band;
      float* dst = s_in + (u % stages) * unit;
      const bool zok = zi >= 0 && zi < nz;
      const float* src = in + (zok ? zi * plane : 0);
      for (int r = warp; r < rows; r += kWarps) {
        const int gy = y0 - hy + b0 + r;
        const bool rok = zok && gy >= 0 && gy < ny;
        const float* srow = src + (rok ? static_cast<int64_t>(gy) * nx : 0);
        for (int c = lane; c < sx; c += 32) {
          const int gx = x0 - hx + c;
          const bool ok = rok && gx >= 0 && gx < nx;
          visfd::cp_async4(dst + r * sx + c, ok ? srow + gx : in, ok);
        }
      }
    }
    visfd::cp_async_commit();
  };

  auto tap4 = [&](int off) -> float4 {
    if constexpr (kSmemTaps) {
      return lds4(s_taps + off);
    } else {
      return __ldg(reinterpret_cast<const float4*>(taps + off));
    }
  };

  if constexpr (kSmemTaps) {  // joins the first unit's group
    for (int i = 4 * threadIdx.x; i < ntaps; i += 4 * kThreads) {
      visfd::cp_async16(s_taps + i, taps + i);
    }
  }
  for (int k = 0; k < stages - 1; ++k) stage(k);

  float acc[TZ][kRx];
#pragma unroll
  for (int p = 0; p < TZ; ++p) {
#pragma unroll
    for (int i = 0; i < kRx; ++i) acc[p][i] = 0.0f;
  }

  for (int u = 0; u < n_units; ++u) {
    if (stages == 3) {
      visfd::cp_async_wait<1>();
    } else {
      visfd::cp_async_wait<0>();
    }
    // unit u (and the taps) landed; unit u - 1's stage is free
    __syncthreads();
    stage(u + stages - 1);
    const float* buf = s_in + (u % stages) * unit;
    // output plane z0 + p takes this input plane with tap plane
    // a = zrel - p (uniform)
    const int zrel = u / nbands;
    const int b0 = (u % nbands) * band;
    const int b1 = min(b0 + band, wy);
    const int p_lo = max(0, zrel - wz + 1);
    const int p_hi = min(nz_out - 1, zrel);
    for (int b = b0; b < b1; ++b) {
      const float* row = buf + (warp + b - b0) * sx + kRx * lane;
      if constexpr (kFixed) {
        constexpr int kWXP = (WX + 3) & ~3;
        constexpr int kNS = (kRx + WX - 1 + 3) & ~3;  // samples loaded
        float s[kNS];
#pragma unroll
        for (int v = 0; v < kNS / 4; ++v) {
          const float4 f = lds4(row + 4 * v);
          s[4 * v] = f.x;
          s[4 * v + 1] = f.y;
          s[4 * v + 2] = f.z;
          s[4 * v + 3] = f.w;
        }
#pragma unroll
        for (int p = 0; p < TZ; ++p) {
          if (p < p_lo || p > p_hi) continue;
          const int k0 = ((zrel - p) * WY + b) * kWXP;
#pragma unroll
          for (int c4 = 0; c4 < kWXP / 4; ++c4) {
            const float4 t = tap4(k0 + 4 * c4);
            const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (4 * c4 + j < WX) {
#pragma unroll
                for (int i = 0; i < kRx; ++i) {
                  acc[p][i] = fmaf(tv[j], s[i + 4 * c4 + j], acc[p][i]);
                }
              }
            }
          }
        }
      } else {
        // the runtime width: the segment 4 columns at a time, a and b
        // holding samples c0 .. c0 + 7 of the lane's first output
        float4 lo = lds4(row);
        int c0 = 0;
        for (; c0 < wx; c0 += 4) {
          const float4 hi = lds4(row + c0 + 4);
          const float s[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
          const int nj = min(4, wx - c0);  // uniform
#pragma unroll
          for (int p = 0; p < TZ; ++p) {
            if (p < p_lo || p > p_hi) continue;
            const float4 t = tap4(((zrel - p) * wy + b) * wxp + c0);
            const float tv[4] = {t.x, t.y, t.z, t.w};
            if (nj == 4) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int i = 0; i < kRx; ++i) {
                  acc[p][i] = fmaf(tv[j], s[i + j], acc[p][i]);
                }
              }
            } else {
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                if (j < nj) {
#pragma unroll
                  for (int i = 0; i < kRx; ++i) {
                    acc[p][i] = fmaf(tv[j], s[i + j], acc[p][i]);
                  }
                }
              }
            }
          }
          lo = hi;
        }
      }
    }
  }

  const int y = y0 + warp;
  const int xb = x0 + kRx * lane;
  if (y >= ny || xb >= nx) return;
  const bool whole = (nx & 3) == 0 && xb + kRx <= nx;
#pragma unroll
  for (int p = 0; p < TZ; ++p) {
    if (p < nz_out) {
      float* o = out + (z0 + p) * plane + static_cast<int64_t>(y) * nx + xb;
      if (whole) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
      } else {
#pragma unroll
        for (int i = 0; i < kRx; ++i) {
          if (xb + i < nx) o[i] = acc[p][i];
        }
      }
    }
  }
}

template <int WZ, int WY, int WX, int TZ, bool kSmemTaps>
int launch(const void* in, void* out, const void* taps, int wx, int wy,
           int wz, int nz, int ny, int nx, int smem, int stages, int band,
           cudaStream_t stream) {
  auto kernel = conv3d_kernel<WZ, WY, WX, TZ, kSmemTaps>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kWarps - 1) / kWarps,
                  (nz + TZ - 1) / TZ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const float*>(taps), wz, wy, wx, nz, ny, nx, band, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// taps: the flipped (wz, wy, wx) kernel, each row padded with zeros to
// wxp = 4 ceil(wx / 4) taps, C order.  variant, smem, stages (2 or 3),
// band and smem_taps from ops/dense_cuda.dense_plan: variant 1-6 the
// compiled widths below (with their TZ), 0 the runtime instance (TZ 4).
extern "C" int visfd_conv3d(const void* in, void* out, const void* taps,
                            int wx, int wy, int wz, int nz, int ny, int nx,
                            int variant, int smem, int stages, int band,
                            int smem_taps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages != 2 && stages != 3) return cudaErrorInvalidValue;
#define VISFD_CONV3D_CASE(V, WZ, WY, WX, TZ)                                \
  case V:                                                                 \
    if (wz != WZ || wy != WY || wx != WX || band != WY || !smem_taps)     \
      return cudaErrorInvalidValue;                                       \
    return launch<WZ, WY, WX, TZ, true>(in, out, taps, wx, wy, wz, nz, ny, \
                                        nx, smem, stages, band, s);
  switch (variant) {
    VISFD_CONV3D_CASE(1, 3, 3, 3, 8)
    VISFD_CONV3D_CASE(2, 5, 5, 5, 8)
    VISFD_CONV3D_CASE(3, 7, 7, 7, 8)
    VISFD_CONV3D_CASE(4, 15, 15, 15, 8)
    VISFD_CONV3D_CASE(5, 1, 21, 21, 4)
    VISFD_CONV3D_CASE(6, 31, 31, 31, 4)
    case 0:
      if (band < 1 || band > wy) return cudaErrorInvalidValue;
      return smem_taps
                 ? launch<0, 0, 0, 4, true>(in, out, taps, wx, wy, wz, nz, ny,
                                            nx, smem, stages, band, s)
                 : launch<0, 0, 0, 4, false>(in, out, taps, wx, wy, wz, nz,
                                             ny, nx, smem, stages, band, s);
    default:
      return cudaErrorInvalidValue;
  }
#undef VISFD_CONV3D_CASE
}
