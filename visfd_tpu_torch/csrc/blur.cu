// Separable 3-D true convolution with zero padding, as one fused pass.
//
// Replaces: visfd_tpu/ops/blur_pallas.py, _blur_kernel (pallas_call in
// _blur3_pallas_impl; entry blur3_pallas, reached from ops/conv._sep3).
// Per axis g[i] = sum_j h[j] f[i - j]; each axis has its own runtime 1-D
// kernel of odd length 2h+1 (asymmetric taps allowed), and samples
// outside the volume are zero.
//
// What bounds it on an H100: device-memory bytes.  The function reads
// and writes each voxel once (8 bytes per voxel) and does 2(2h+1)
// operations per axis; at h = 4 that is 54 operations for 8 bytes, far
// below the card's ~20 operations per byte.  So the design keeps the
// two intermediate volumes of a pass-per-axis blur out of device memory.
//
// Design (the TPU kernel's: an xy-blurred plane ring that marches in z).
// A block owns a tile of (y, x) output columns, 32 wide, and a chunk of
// kTZ output planes.  It marches over the input
// planes the chunk needs (kTZ + 2hz); cp.async keeps kStages - 1
// planes' (by + 2hy) x (32 + 2hx) haloed footprints in flight into
// shared memory, zero outside the volume.  A plane is convolved along
// x (every row of the footprint) at one step and along y at the next,
// beside the x pass of the next plane, so each step has one barrier.
// Each thread then adds its xy-blurred value, with the z taps, to the
// 2hz+1 output planes it reaches and writes the one it completes.
// Input planes beyond the volume enter as zeros.  One halfwidth 1-8 on
// every axis is compiled as such: a 32 x 32 tile, each thread 4
// adjacent output rows (their y windows share 4 + 2hy x-blurred rows,
// read once), taps, footprint offsets and the 2hz+1 running z sums in
// registers.  Other widths run one runtime instantiation of the same
// code: one output row per thread, taps and a ring of 2hz+1 xy-blurred
// planes in shared memory, z summed when the ring holds z - hz .. z +
// hz.
//
// Per-axis mode, for halfwidths whose fused tile does not fit in shared
// memory (ops/blur_cuda.smem_plan returns None; the JAX package sends
// kernels longer than 61 taps to XLA's conv1d, visfd_tpu/ops/conv.py:96):
// one launch per axis, x then y then z, each a 1-D convolution with a
// runtime halfwidth of any size.  A block owns a segment of one line
// (x) or of 32 neighbouring lines (y, z) and walks the sources its
// segment reaches, [s0 - h, s0 + seg + h), in chunks staged in shared
// memory (zeros outside the volume); each output adds, per chunk, the
// taps whose sources it holds, so every output sums its 2h+1 taps in
// ascending order of the source, padded samples included as zeros: the
// fused kernel's sums, bit for bit, and a -mesh block's interior gets
// the single-device bits.  Bound: operations, 2(2h+1) per voxel and
// axis (at h = 60, 726 a voxel against 8 bytes moved per pass).
//
// Invariants.  Every output voxel sums, per axis, all 2h+1 taps in
// ascending order of the source (x, then y, then z; the TPU kernel
// takes y, then x, then z, and the twin z, y, x), padded samples
// included as zeros, whatever its place in the tile, the chunk or the
// volume; so a block of a -mesh run, haloed and blurred, gives its
// interior the single-device bits.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBX = 32;
constexpr int kTZ = 32;      // output planes per block
constexpr int kStages = 3;   // staged input planes (kStages - 1 in flight)
// the compile-time widths: 8 rows of threads, kR adjacent output rows
// each, so a tile is 32 x 32 and a thread's y windows share their rows
constexpr int kFixedThreadRows = 8;
constexpr int kR = 4;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;  // 0: fill with zeros, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// H > 0: hx = hy = hz = H at compile time; H == 0: runtime halfwidths,
// one output row per thread, the rows of the launch.
template <int H>
__global__ void __launch_bounds__(256)
    blur3_kernel(const float* __restrict__ in, float* __restrict__ out,
                 const float* __restrict__ taps, int hx_rt, int hy_rt,
                 int hz_rt, int nz, int ny, int nx) {
  constexpr bool kFixed = H > 0;
  constexpr int R = kFixed ? kR : 1;  // output rows per thread
  const int hx = kFixed ? H : hx_rt, hy = kFixed ? H : hy_rt;
  const int hz = kFixed ? H : hz_rt;
  const int trows = kFixed ? kFixedThreadRows : static_cast<int>(blockDim.y);
  const int by = trows * R;  // tile rows
  const int RY = by + 2 * hy, SX = kBX + 2 * hx, WZ = 2 * hz + 1;
  const int nthreads = kBX * trows;
  const int plane = RY * SX;
  extern __shared__ __align__(16) float sm[];
  float* s_in = sm;                        // [kStages][RY][SX]
  float* s_x = s_in + kStages * plane;     // [2][RY][32], x-blurred rows
  float* ring = s_x + 2 * RY * kBX;        // runtime: [WZ][by * 32]
  float* s_k = ring + (kFixed ? 0 : WZ * nthreads);  // runtime: kz|ky|kx

  const int lx = threadIdx.x, ly = threadIdx.y;
  const int tid = ly * kBX + lx;
  const int x0 = blockIdx.x * kBX, y0 = blockIdx.y * by;
  const int z0 = blockIdx.z * kTZ;

  constexpr int kW = kFixed ? 2 * H + 1 : 1;
  float kzr[kW], kyr[kW], kxr[kW], acc[R][kW];
  if constexpr (kFixed) {
#pragma unroll
    for (int t = 0; t < kW; ++t) {
      kzr[t] = __ldg(taps + t);
      kyr[t] = __ldg(taps + kW + t);
      kxr[t] = __ldg(taps + 2 * kW + t);
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q][t] = 0.0f;
    }
  } else {
    const int n_taps = WZ + 2 * hy + 1 + 2 * hx + 1;
    for (int i = tid; i < n_taps; i += nthreads) s_k[i] = taps[i];
  }
  const float* kz = s_k;
  const float* ky = kz + WZ;
  const float* kx = ky + 2 * hy + 1;

  const int64_t nplane = static_cast<int64_t>(ny) * nx;
  const int zo_end = min(z0 + kTZ, nz) - 1;   // last output plane
  const int z_first = z0 - hz, z_last = zo_end + hz;  // input planes
  const int zr_lo = max(z_first, 0);         // those in the volume
  const int zr_hi = min(z_last, nz - 1);

  // the compile-time widths keep this thread's footprint offsets in the
  // plane (-1: outside the volume) in registers: the same every plane
  constexpr int kNE =
      kFixed ? ((kFixedThreadRows * kR + 2 * H) * (kBX + 2 * H) +
                kBX * kFixedThreadRows - 1) / (kBX * kFixedThreadRows)
             : 1;
  int goff[kNE];
  if constexpr (kFixed) {
#pragma unroll
    for (int j = 0; j < kNE; ++j) {
      const int e = tid + j * nthreads;
      const int r = e / SX, c = e - r * SX;
      const int gy = y0 - hy + r, gx = x0 - hx + c;
      goff[j] = e < plane && gy >= 0 && gy < ny && gx >= 0 && gx < nx
                    ? gy * nx + gx
                    : -1;
    }
  }

  // one cp.async group per plane (empty beyond zr_hi), so that "all but
  // the newest kStages - 2 groups" is always the plane being x-blurred
  auto stage = [&](int zi) {
    if (zi <= zr_hi) {
      const float* src = in + zi * nplane;
      float* dst = s_in + ((zi - zr_lo) % kStages) * plane;
      if constexpr (kFixed) {
#pragma unroll
        for (int j = 0; j < kNE; ++j) {
          const int e = tid + j * nthreads;
          if (e < plane) cp_async4(dst + e, goff[j] >= 0 ? src + goff[j] : in,
                                   goff[j] >= 0);
        }
      } else {
        for (int e = tid; e < plane; e += nthreads) {
          const int r = e / SX, c = e - r * SX;
          const int gy = y0 - hy + r, gx = x0 - hx + c;
          const bool ok = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
          cp_async4(dst + e,
                    ok ? src + static_cast<int64_t>(gy) * nx + gx : in, ok);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) stage(zr_lo + k);
  int slot = 0;  // runtime ring: slot of the plane being y-blurred
  // step zx: x-blur plane zx and y-blur plane zx - 1 (x-blurred at the
  // step before), one barrier per step
  for (int zx = z_first; zx <= z_last + 1; ++zx) {
    const bool x_real = zx >= zr_lo && zx <= zr_hi;  // uniform
    if (x_real) asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    // barrier: plane zx has landed (and the taps are in place); the rows
    // x-blurred at the last step are complete; plane zx - 1's input
    // buffer and plane zx - 2's rows are free
    __syncthreads();
    if (x_real) {
      stage(zx + kStages - 1);
      const float* p = s_in + ((zx - zr_lo) % kStages) * plane;
      float* xr = s_x + ((zx - zr_lo) & 1) * RY * kBX;
      for (int r = ly; r < RY; r += trows) {
        const float* row = p + r * SX + lx;
        float a = 0.0f;
        if constexpr (kFixed) {
#pragma unroll
          for (int t = 0; t < kW; ++t) a = fmaf(kxr[kW - 1 - t], row[t], a);
        } else {
          for (int t = 0; t <= 2 * hx; ++t) {
            a = fmaf(kx[2 * hx - t], row[t], a);
          }
        }
        xr[r * kBX + lx] = a;
      }
    }
    const int zy = zx - 1;
    if (zy < z_first) continue;  // uniform
    const bool y_real = zy >= zr_lo && zy <= zr_hi;  // uniform
    const float* xr = s_x + ((zy - zr_lo) & 1) * RY * kBX + ly * R * kBX + lx;
    const int zo = zy - hz;
    float a[R];
    if constexpr (kFixed) {
      // this thread's R output rows read R + 2H x-blurred rows
      float w[R + 2 * H], v[R];
#pragma unroll
      for (int t = 0; t < R + 2 * H; ++t) w[t] = y_real ? xr[t * kBX] : 0.0f;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        v[q] = 0.0f;
#pragma unroll
        for (int t = 0; t < kW; ++t) {
          v[q] = fmaf(kyr[kW - 1 - t], w[q + t], v[q]);
        }
      }
      // acc[q][j] sums output plane zy - H + j: plane zy enters it with
      // tap kz[j], so each output adds its inputs in ascending z
#pragma unroll
      for (int q = 0; q < R; ++q) {
#pragma unroll
        for (int j = 0; j < kW; ++j) acc[q][j] = fmaf(kzr[j], v[q], acc[q][j]);
        a[q] = acc[q][0];
#pragma unroll
        for (int j = 0; j + 1 < kW; ++j) acc[q][j] = acc[q][j + 1];
        acc[q][kW - 1] = 0.0f;
      }
    } else {
      float v = 0.0f;
      if (y_real) {
        for (int t = 0; t <= 2 * hy; ++t) {
          v = fmaf(ky[2 * hy - t], xr[t * kBX], v);
        }
      }
      ring[slot * nthreads + tid] = v;  // this thread's own column
      slot = slot + 1 == WZ ? 0 : slot + 1;
      a[0] = 0.0f;
      if (zo >= z0) {
        // the ring holds input planes zo - hz .. zo + hz from slot on
        int s = slot;
        for (int t = 0; t < WZ; ++t) {
          a[0] = fmaf(kz[2 * hz - t], ring[s * nthreads + tid], a[0]);
          s = s + 1 == WZ ? 0 : s + 1;
        }
      }
    }
    const int x = x0 + lx;
    if (zo >= z0 && x < nx) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int y = y0 + ly * R + q;
        if (y < ny) out[zo * nplane + static_cast<int64_t>(y) * nx + x] = a[q];
      }
    }
  }
}

template <int H>
int launch(const void* in, void* out, const void* taps, int hx, int hy,
           int hz, int nz, int ny, int nx, int by, int smem,
           cudaStream_t stream) {
  auto kernel = blur3_kernel<H>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tile_rows = H > 0 ? kFixedThreadRows * kR : by;
  const dim3 block(kBX, by);
  const dim3 grid((nx + kBX - 1) / kBX, (ny + tile_rows - 1) / tile_rows,
                  (nz + kTZ - 1) / kTZ);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const float*>(taps), hx, hy, hz, nz, ny, nx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// taps: kz | ky | kx, each of odd length 2h+1; by (rows of threads)
// and smem from ops/blur_cuda.smem_plan, which gives the compile-time
// widths (one halfwidth 1-8 on every axis) 8 rows of threads.
extern "C" int visfd_blur3(const void* in, void* out, const void* taps,
                           int hx, int hy, int hz, int nz, int ny, int nx,
                           int by, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VISFD_BLUR_CASE(H)                                                 \
  case H:                                                                  \
    return launch<H>(in, out, taps, hx, hy, hz, nz, ny, nx, by, smem, s);
  if (hx == hy && hy == hz && by == kFixedThreadRows) {
    switch (hx) {
      VISFD_BLUR_CASE(1)
      VISFD_BLUR_CASE(2)
      VISFD_BLUR_CASE(3)
      VISFD_BLUR_CASE(4)
      VISFD_BLUR_CASE(5)
      VISFD_BLUR_CASE(6)
      VISFD_BLUR_CASE(7)
      VISFD_BLUR_CASE(8)
      default:
        break;
    }
  }
#undef VISFD_BLUR_CASE
  return launch<0>(in, out, taps, hx, hy, hz, nz, ny, nx, by, smem, s);
}

// ---------------------------------------------------------------------------
// per-axis mode

namespace {

constexpr int kAxSegX = 1024;   // x: outputs of a line per block
constexpr int kAxChunkX = 4096;  // x: sources staged per chunk
constexpr int kAxSegS = 64;     // y, z: outputs of each line per block
constexpr int kAxChunkS = 128;  // y, z: sources staged per chunk and line
constexpr int kAxRows = 8;      // y, z: rows of threads (32 lines wide)

// along x: line = blockIdx.x (a (z, y) row), outputs s0 .. s0 + 1023
__global__ void __launch_bounds__(256)
    blur_axis_x_kernel(const float* __restrict__ in, float* __restrict__ out,
                       const float* __restrict__ taps, int h, int nx) {
  __shared__ float s[kAxChunkX];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * nx;
  const int s0 = blockIdx.y * kAxSegX;
  const int lo = s0 - h;                             // first source
  const int hi = min(s0 + kAxSegX, nx) - 1 + h;      // last source
  float acc[kAxSegX / 256];
#pragma unroll
  for (int q = 0; q < kAxSegX / 256; ++q) acc[q] = 0.0f;
  for (int c0 = lo; c0 <= hi; c0 += kAxChunkX) {
    const int c1 = min(c0 + kAxChunkX, hi + 1);      // chunk [c0, c1)
    __syncthreads();  // the last chunk's readers are done
    for (int j = c0 + threadIdx.x; j < c1; j += 256) {
      s[j - c0] = j >= 0 && j < nx ? in[base + j] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kAxSegX / 256; ++q) {
      const int i = s0 + threadIdx.x + 256 * q;
      const int a = max(c0, i - h), b = min(c1, i + h + 1);
      float v = acc[q];
      for (int j = a; j < b; ++j) v = fmaf(__ldg(taps + h + i - j), s[j - c0], v);
      acc[q] = v;
    }
  }
#pragma unroll
  for (int q = 0; q < kAxSegX / 256; ++q) {
    const int i = s0 + threadIdx.x + 256 * q;
    if (i < nx) out[base + i] = acc[q];
  }
}

// along y or z of a (outer, n, inner) layout: lines inner0 .. inner0 + 31
// of outer index blockIdx.z, outputs s0 .. s0 + 63 along the axis
__global__ void __launch_bounds__(256)
    blur_axis_strided_kernel(const float* __restrict__ in,
                             float* __restrict__ out,
                             const float* __restrict__ taps, int h, int n,
                             int64_t inner) {
  __shared__ float s[kAxChunkS * 32];
  const int lx = threadIdx.x, ly = threadIdx.y;
  const int64_t line = static_cast<int64_t>(blockIdx.x) * 32 + lx;
  const bool live = line < inner;
  const int64_t base = static_cast<int64_t>(blockIdx.z) * n * inner + line;
  const int s0 = blockIdx.y * kAxSegS;
  const int lo = s0 - h;
  const int hi = min(s0 + kAxSegS, n) - 1 + h;
  float acc[kAxSegS / kAxRows];
#pragma unroll
  for (int q = 0; q < kAxSegS / kAxRows; ++q) acc[q] = 0.0f;
  for (int c0 = lo; c0 <= hi; c0 += kAxChunkS) {
    const int c1 = min(c0 + kAxChunkS, hi + 1);
    __syncthreads();
    for (int j = c0 + ly; j < c1; j += kAxRows) {
      s[(j - c0) * 32 + lx] =
          live && j >= 0 && j < n ? in[base + static_cast<int64_t>(j) * inner]
                                  : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kAxSegS / kAxRows; ++q) {
      const int i = s0 + ly + kAxRows * q;
      const int a = max(c0, i - h), b = min(c1, i + h + 1);
      float v = acc[q];
      for (int j = a; j < b; ++j) {
        v = fmaf(__ldg(taps + h + i - j), s[(j - c0) * 32 + lx], v);
      }
      acc[q] = v;
    }
  }
  if (!live) return;
#pragma unroll
  for (int q = 0; q < kAxSegS / kAxRows; ++q) {
    const int i = s0 + ly + kAxRows * q;
    if (i < n) out[base + static_cast<int64_t>(i) * inner] = acc[q];
  }
}

}  // namespace

// One 1-D convolution along ``axis`` (0: z, 1: y, 2: x) of a (nz, ny, nx)
// volume; taps of length 2h+1, g[i] = sum_j taps[h + i - j] f[j].
extern "C" int visfd_blur_axis(const void* in, void* out, const void* taps,
                               int h, int nz, int ny, int nx, int axis,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(in);
  float* dst = static_cast<float*>(out);
  const float* k = static_cast<const float*>(taps);
  if (axis == 2) {
    const dim3 grid(nz * ny, (nx + kAxSegX - 1) / kAxSegX);
    blur_axis_x_kernel<<<grid, 256, 0, st>>>(src, dst, k, h, nx);
  } else {
    const int n = axis == 1 ? ny : nz;
    const int outer = axis == 1 ? nz : 1;
    const int64_t inner = axis == 1 ? static_cast<int64_t>(nx)
                                    : static_cast<int64_t>(ny) * nx;
    const dim3 grid(static_cast<unsigned>((inner + 31) / 32),
                    (n + kAxSegS - 1) / kAxSegS, outer);
    blur_axis_strided_kernel<<<grid, dim3(32, kAxRows), 0, st>>>(
        src, dst, k, h, n, inner);
  }
  return static_cast<int>(cudaGetLastError());
}
