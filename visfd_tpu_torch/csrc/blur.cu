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
// Input planes beyond the volume enter as zeros.  One halfwidth 1-5 on
// every axis is compiled as such: a 32 x 32 tile, each thread 4
// adjacent output rows (their y windows share 4 + 2hy x-blurred rows,
// read once), taps, footprint offsets and the 2hz+1 running z sums in
// registers.  One halfwidth 6-10 on every axis runs the wide instance
// below.  Other widths run one runtime instantiation of the same
// code: one output row per thread, taps and a ring of 2hz+1 xy-blurred
// planes in shared memory, z summed when the ring holds z - hz .. z +
// hz.
//
// Wide instance (blur3_kernel_wide<H>: one halfwidth H of 6-10 on every
// axis, the blob ladder's LoG widths).  What bounds it on an H100:
// instruction slots and their latency, not bytes: 3(2H+1) FMAs a voxel
// (63 at H = 10) and the shared-memory reads that feed them, against 8
// bytes moved (1.3-2.0 ms at 268M voxels against a 0.64 ms byte bound,
// PERF.md §6).
// A block of 8 warps owns a 32 x 32 tile and marches over the chunk of
// planes ops/blur_cuda.wide_chunk picks (the whole depth at 268M), two
// blocks an SM (128 registers a thread):
// - four staged planes of (32 + 2H) x (32 + 2a) sources, a = H rounded
//   up to 4, by 16-byte cp.async (4-byte where rows are not 16-byte
//   aligned); a row is padded by 4 floats so that a warp's float4 reads
//   of two rows fall on other banks;
// - the x pass: 8 adjacent outputs a thread from a window of sources read
//   as float4s into registers;
// - the y pass: 4 output rows a thread from a window of 4 + 2H x-blurred
//   rows in registers;
// - z: each column's 2H+1 running sums in registers, moved down one
//   register a step (renaming them by a switch on the step's phase was
//   measured slower);
// - the taps in shared memory, each axis in the walk's order, read as
//   warp-uniform broadcasts, so that registers go to the sums.
// Why the compiled instances stop at 5: they keep 3(2H+1) taps in
// registers beside the 4(2H+1) sums, so past H = 8 they no longer fit a
// thread's registers, and at 6-8 (163-189 registers) an SM held one
// block of 8 warps and they ran 2.3-2.9x slower than the wide instance.
//
// Per-axis mode, for halfwidths whose fused tile does not fit in shared
// memory (ops/blur_cuda.smem_plan returns None; the JAX package sends
// kernels longer than 61 taps to XLA's conv1d, visfd_tpu/ops/conv.py:96):
// one launch per axis, x then y then z, each a 1-D convolution with a
// runtime halfwidth of any size.  Bound: operations, 2(2h+1) per voxel
// and axis (at h = 60, 726 a voxel against 8 bytes moved per pass), so
// a tap is a warp-uniform broadcast and each source feeds 16 outputs
// from a register.  A block owns 32 lines (the lanes) and a segment of
// 128 outputs along the axis, 16 adjacent ones a thread; it stages the
// sources the segment reaches, [s0 - h, s0 + 128 + h), and the taps in
// reverse, in chunks of 216 taps in shared memory (zeros outside the
// volume), a source row of the 32 lines at a time.  The x pass stages
// its 32 rows transposed (and stores its outputs back through shared
// memory), so that every pass has the lanes on 32 lines and the tap
// index the same across the warp.  A thread walks its sources in
// ascending order through a window of 24 registers, rotated in place:
// each step of 8 taps loads the next 8 sources and two float4s of taps
// for 128 FMAs.  So every output
// sums its 2h+1 taps in ascending order of the source from 0.0f, padded
// samples included as zeros: the fused kernel's sums, bit for bit, and
// a -mesh block's interior gets the single-device bits.
//
// Invariants.  Every output voxel sums, per axis, all 2h+1 taps in
// ascending order of the source (x, then y, then z; the TPU kernel
// takes y, then x, then z, and the twin z, y, x), padded samples
// included as zeros, whatever its place in the tile, the chunk or the
// volume; so a block of a -mesh run, haloed and blurred, gives its
// interior the single-device bits.

#include <cuda_runtime.h>
#include <cstdint>

#include "cp_async.cuh"

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
// widths (one halfwidth 1-5 on every axis) 8 rows of threads.
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
      default:
        break;
    }
  }
#undef VISFD_BLUR_CASE
  return launch<0>(in, out, taps, hx, hy, hz, nz, ny, nx, by, smem, s);
}

// ---------------------------------------------------------------------------
// wide instance (see the header note)

namespace {

constexpr int kWStages = 4;  // staged input planes (kWStages - 1 in flight)
constexpr int kWWarps = 8;   // a block's warps, kR output rows a thread
constexpr int kWXR = 8;      // adjacent x outputs a thread in the x pass

template <int H>
struct WideTile {
  static constexpr int W = 2 * H + 1;          // taps an axis
  static constexpr int WP = (W + 3) / 4 * 4;   // ... padded to float4s
  static constexpr int A = (H + 3) / 4 * 4;    // x halo staged (16 B)
  static constexpr int OFF = A - H;  // column 0's first source, staged
  static constexpr int SX = kBX + 2 * A;       // staged row
  static constexpr int SXP = SX + 4;           // its stride: 4 mod 8 banks
  static constexpr int NV = (OFF + kWXR + 2 * H + 3) / 4;  // float4s a window
  static constexpr int XS = kBX + 4;           // x-blurred row stride
  static constexpr int TY = kWWarps * kR;      // tile rows
  static constexpr int RY = TY + 2 * H;        // staged rows
  static constexpr int PLANE = RY * SXP;
  static constexpr int NT = kWWarps * 32;
  static constexpr int NC = SX / 4;            // 16-byte chunks a row
  static constexpr int NE = (RY * NC + NT - 1) / NT;  // a thread's chunks
  static constexpr int SMEM = 4 * (kWStages * PLANE + 2 * RY * XS + 3 * WP);
  static_assert(kBX - kWXR + 4 * NV <= SX, "x window in the row");
};

template <int H>
__global__ void __launch_bounds__(kWWarps * 32, 2)
    blur3_kernel_wide(const float* __restrict__ in, float* __restrict__ out,
                      const float* __restrict__ taps, int nz, int ny, int nx,
                      int tz, int vec) {
  using T = WideTile<H>;
  constexpr int W = T::W;
  extern __shared__ __align__(16) float sm[];
  float* s_in = sm;                            // [kWStages][RY][SXP]
  float* s_x = s_in + kWStages * T::PLANE;     // [2][RY][XS], x-blurred
  float* s_k = s_x + 2 * T::RY * T::XS;        // kz | ky | kx, [3][WP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * kBX, y0 = blockIdx.y * T::TY;
  const int z0 = blockIdx.z * tz;

  // each axis' taps in the order of the walk from the lowest source (tap
  // d is k[2H - d]), zeros past W; read as warp-uniform float4s
  for (int i = tid; i < 3 * T::WP; i += T::NT) {
    const int a = i / T::WP, d = i - a * T::WP;
    s_k[i] = d < W ? taps[a * W + 2 * H - d] : 0.0f;
  }
  const float* kz = s_k;
  const float* ky = s_k + T::WP;
  const float* kx = s_k + 2 * T::WP;

  const int64_t nplane = static_cast<int64_t>(ny) * nx;
  const int zo_end = min(z0 + tz, nz) - 1;            // last output plane
  const int z_first = z0 - H, z_last = zo_end + H;    // input planes
  const int zr_lo = max(z_first, 0);                  // those in the volume
  const int zr_hi = min(z_last, nz - 1);

  // vec: 16-byte chunks, this thread's offsets in the plane (-1: outside
  // the volume, zeros; -2: past the footprint), the same every plane
  int goff[T::NE];
#pragma unroll
  for (int j = 0; j < T::NE; ++j) {
    const int e = tid + j * T::NT;
    const int r = e / T::NC, c = e - r * T::NC;
    const int gy = y0 - H + r, gx = x0 - T::A + 4 * c;
    goff[j] = e >= T::RY * T::NC ? -2
              : gy >= 0 && gy < ny && gx >= 0 && gx < nx ? gy * nx + gx
                                                         : -1;
  }

  // one cp.async group per plane (empty beyond zr_hi), as blur3_kernel
  auto stage = [&](int zi) {
    if (zi <= zr_hi) {
      const float* src = in + zi * nplane;
      float* dst = s_in + ((zi - zr_lo) % kWStages) * T::PLANE;
      if (vec) {
#pragma unroll
        for (int j = 0; j < T::NE; ++j) {
          if (goff[j] == -2) continue;
          const int e = tid + j * T::NT;
          const int r = e / T::NC, c = e - r * T::NC;
          visfd::cp_async16(dst + r * T::SXP + 4 * c,
                            goff[j] >= 0 ? src + goff[j] : in, goff[j] >= 0);
        }
      } else {
        for (int e = tid; e < T::RY * T::SX; e += T::NT) {
          const int r = e / T::SX, c = e - r * T::SX;
          const int gy = y0 - H + r, gx = x0 - T::A + c;
          const bool ok = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
          visfd::cp_async4(dst + r * T::SXP + c,
                           ok ? src + static_cast<int64_t>(gy) * nx + gx : in,
                           ok);
        }
      }
    }
    visfd::cp_async_commit();
  };

#pragma unroll
  for (int k = 0; k < kWStages - 1; ++k) stage(zr_lo + k);
  float acc[kR][W];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
#pragma unroll
    for (int j = 0; j < W; ++j) acc[q][j] = 0.0f;
  }
  const int x = x0 + lane, yb = y0 + warp * kR;
  // step zx: x-blur plane zx and y-blur plane zx - 1 (x-blurred at the
  // step before), one barrier per step
  for (int zx = z_first; zx <= z_last + 1; ++zx) {
    const bool x_real = zx >= zr_lo && zx <= zr_hi;  // uniform
    if (x_real) visfd::cp_async_wait<kWStages - 2>();
    // barrier: plane zx has landed (and the taps are in place); the rows
    // x-blurred at the last step are complete; plane zx - 1's input
    // buffer and plane zx - 2's rows are free
    __syncthreads();
    if (x_real) {
      stage(zx + kWStages - 1);
      const float* p = s_in + ((zx - zr_lo) % kWStages) * T::PLANE;
      float* xr = s_x + ((zx - zr_lo) & 1) * T::RY * T::XS;
      // kWXR adjacent outputs of a row a thread, from one window of
      // sources in registers
      for (int i = tid; i < T::RY * (kBX / kWXR); i += T::NT) {
        const int r = i / (kBX / kWXR), c = kWXR * (i % (kBX / kWXR));
        const float4* row =
            reinterpret_cast<const float4*>(p + r * T::SXP + c);
        float w[4 * T::NV], a[kWXR];
#pragma unroll
        for (int u = 0; u < T::NV; ++u) {
          const float4 f = row[u];
          w[4 * u] = f.x;
          w[4 * u + 1] = f.y;
          w[4 * u + 2] = f.z;
          w[4 * u + 3] = f.w;
        }
#pragma unroll
        for (int j = 0; j < kWXR; ++j) a[j] = 0.0f;
#pragma unroll
        for (int t4 = 0; t4 < W; t4 += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kx + t4);
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (t4 + e < W) {
#pragma unroll
              for (int j = 0; j < kWXR; ++j) {
                a[j] = fmaf(kk[e], w[T::OFF + j + t4 + e], a[j]);
              }
            }
          }
        }
        float4* dst = reinterpret_cast<float4*>(xr + r * T::XS + c);
#pragma unroll
        for (int u = 0; u < kWXR / 4; ++u) {
          dst[u] = make_float4(a[4 * u], a[4 * u + 1], a[4 * u + 2],
                               a[4 * u + 3]);
        }
      }
    }
    const int zy = zx - 1;
    if (zy < z_first) continue;  // uniform
    // this thread's kR output rows read kR + 2H x-blurred rows
    float v[kR], o[kR];
#pragma unroll
    for (int q = 0; q < kR; ++q) v[q] = 0.0f;
    if (zy >= zr_lo && zy <= zr_hi) {  // uniform
      const float* xr = s_x + ((zy - zr_lo) & 1) * T::RY * T::XS +
                        warp * kR * T::XS + lane;
      float w[kR + 2 * H];
#pragma unroll
      for (int t = 0; t < kR + 2 * H; ++t) w[t] = xr[t * T::XS];
#pragma unroll
      for (int t4 = 0; t4 < W; t4 += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(ky + t4);
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (t4 + e < W) {
#pragma unroll
            for (int q = 0; q < kR; ++q) {
              v[q] = fmaf(kk[e], w[q + t4 + e], v[q]);
            }
          }
        }
      }
    }
    // acc[q][j] sums output plane zy - H + j: plane zy enters it with the
    // z kernel's tap j (kz[2H - j] in the walk's order), so each output
    // adds its inputs in ascending z; plane zy - H's sum is complete
#pragma unroll
    for (int j = 0; j < W; ++j) {
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        acc[q][j] = fmaf(kz[2 * H - j], v[q], acc[q][j]);
      }
    }
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      o[q] = acc[q][0];
#pragma unroll
      for (int j = 0; j + 1 < W; ++j) acc[q][j] = acc[q][j + 1];
      acc[q][W - 1] = 0.0f;
    }
    const int zo = zy - H;
    if (zo >= z0 && x < nx) {
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        if (yb + q < ny) {
          out[zo * nplane + static_cast<int64_t>(yb + q) * nx + x] = o[q];
        }
      }
    }
  }
}

template <int H>
int launch_wide(const void* in, void* out, const void* taps, int nz, int ny,
                int nx, int tz, int smem, cudaStream_t stream) {
  using T = WideTile<H>;
  if (smem < T::SMEM || tz < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = blur3_kernel_wide<H>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  // 16-byte staging needs aligned rows; else 4-byte copies of the same
  const int vec = (reinterpret_cast<uintptr_t>(in) & 15) == 0 && nx % 4 == 0;
  const dim3 grid((nx + kBX - 1) / kBX, (ny + T::TY - 1) / T::TY,
                  (nz + tz - 1) / tz);
  kernel<<<grid, T::NT, T::SMEM, stream>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const float*>(taps), nz, ny, nx, tz, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wide instance at halfwidth h on every axis (taps kz | ky | kx, each
// of length 2h+1); tz output planes a block (ops/blur_cuda.wide_chunk),
// smem at least the instance's (ops/blur_cuda.smem_plan).
extern "C" int visfd_blur3_wide(const void* in, void* out, const void* taps,
                                int h, int nz, int ny, int nx, int tz,
                                int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h) {
#define VISFD_WIDE_CASE(H) \
  case H:                  \
    return launch_wide<H>(in, out, taps, nz, ny, nx, tz, smem, s);
    VISFD_WIDE_CASE(6)
    VISFD_WIDE_CASE(7)
    VISFD_WIDE_CASE(8)
    VISFD_WIDE_CASE(9)
    VISFD_WIDE_CASE(10)
#undef VISFD_WIDE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// per-axis mode

namespace {

constexpr int kAxWarps = 8;
constexpr int kAxLd = 33;  // stride of a staged source row
constexpr int kAxG = 2;    // a thread's groups of 8 adjacent outputs
constexpr int kAxR = 8 * kAxG;           // adjacent outputs a thread
constexpr int kAxSeg = kAxR * kAxWarps;  // outputs of each line a block
// taps a staged chunk: a multiple of a rotation of the window
// (8 (kAxG + 1)) whose sources, chunk + kAxSeg rows of 33 floats, stay
// within 48 KB
constexpr int kAxChunk = 216;

// 8 taps of the window walk.  The window holds kAxG + 1 groups of 8
// sources; logical group j (sources 8j .. 8j + 7 past the thread's first
// output's tap u) is physical group (st + j) % (kAxG + 1).  Output r of
// group g takes tap k from source r + k of logical group g, or of g + 1
// past 8.  kTail: only the first nt taps.
template <int st, bool kTail>
__device__ __forceinline__ void axis_step(float (&acc)[kAxG][8],
                                          const float (&w)[kAxG + 1][8],
                                          const float* t, int nt) {
  const float4 t0 = *reinterpret_cast<const float4*>(t);
  const float4 t1 = *reinterpret_cast<const float4*>(t + 4);
  const float tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (!kTail || k < nt) {
#pragma unroll
      for (int g = 0; g < kAxG; ++g) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int j = g + (r + k >= 8 ? 1 : 0);
          acc[g][r] = fmaf(tv[k], w[(st + j) % (kAxG + 1)][(r + k) & 7],
                           acc[g][r]);
        }
      }
    }
  }
}

// steps st .. kAxG of one rotation of the window, from tap u (chunk-
// relative; sp: the thread's first source row)
template <int st>
__device__ __forceinline__ void axis_rotation(float (&acc)[kAxG][8],
                                              float (&w)[kAxG + 1][8],
                                              const float* sp,
                                              const float* s_t, int u) {
  if constexpr (st <= kAxG) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      w[(st + kAxG) % (kAxG + 1)][r] = sp[(u + 8 * kAxG + r) * kAxLd];
    }
    axis_step<st, false>(acc, w, s_t + u, 8);
    axis_rotation<st + 1>(acc, w, sp, s_t, u + 8);
  }
}

// One 1-D convolution of 32 lines a block, outputs s0 .. s0 + kAxSeg - 1
// of each (kAxR adjacent ones a thread, warp w's from s0 + kAxR w).
// kRows (the x pass): line blockIdx.x * 32 + l is row l of a (lines, n)
// layout, staged transposed; else the lines are (blockIdx.z,
// blockIdx.x * 32 + lane) of an (outer, n, inner) layout.
template <bool kRows>
__global__ void __launch_bounds__(kAxWarps * 32)
    blur_axis_kernel(const float* __restrict__ in, float* __restrict__ out,
                     const float* __restrict__ taps, int h, int n,
                     int64_t inner, int64_t lines) {
  __shared__ float s[(kAxChunk + kAxSeg) * kAxLd];  // [source][line]
  __shared__ __align__(16) float s_t[kAxChunk];     // the chunk's taps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = blockIdx.y * kAxSeg;
  const int nu = 2 * h + 1;
  const int64_t line0 = static_cast<int64_t>(blockIdx.x) * 32;
  // the first source of output s0 is s0 - h; output s0 + kAxR w + r
  // takes tap u from source s0 - h + kAxR w + r + u
  const float* col = nullptr;  // kRows == false: this lane's line
  bool col_ok = false;
  if constexpr (!kRows) {
    col_ok = line0 + lane < inner;
    col = in + blockIdx.z * static_cast<int64_t>(n) * inner +
          (col_ok ? line0 + lane : 0);
  }
  float acc[kAxG][8], w[kAxG + 1][8];
#pragma unroll
  for (int g = 0; g < kAxG; ++g) {
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[g][r] = 0.0f;
  }

  // warps whose outputs all lie past the line stage but compute nothing
  const bool busy = s0 + kAxR * warp < n;
  for (int uc = 0; uc < nu; uc += kAxChunk) {
    const int ue = min(uc + kAxChunk, nu);
    const int nt8 = (ue - uc + 7) & ~7;
    const int npos = nt8 + kAxSeg;  // sources this chunk reads
    __syncthreads();  // the last chunk's readers are done
    const int p0 = s0 - h + uc;     // source of staged row 0
    if constexpr (kRows) {
      for (int l = warp; l < 32; l += kAxWarps) {
        const bool lok = line0 + l < lines;
        const float* src = in + (lok ? (line0 + l) * n : 0);
        for (int q = lane; q < npos; q += 32) {
          const int gp = p0 + q;
          const bool ok = lok && gp >= 0 && gp < n;
          visfd::cp_async4(&s[q * kAxLd + l], ok ? src + gp : in, ok);
        }
      }
    } else {
      for (int q = warp; q < npos; q += kAxWarps) {
        const int gp = p0 + q;
        const bool ok = col_ok && gp >= 0 && gp < n;
        visfd::cp_async4(&s[q * kAxLd + lane], ok ? col + gp * inner : in,
                         ok);
      }
    }
    // tap u of the walk is taps[2h - u]; zeros past the last
    for (int t = threadIdx.x; t < nt8; t += kAxWarps * 32) {
      const bool ok = uc + t < nu;
      visfd::cp_async4(&s_t[t], ok ? taps + nu - 1 - uc - t : taps, ok);
    }
    visfd::cp_async_commit();
    visfd::cp_async_wait<0>();
    __syncthreads();
    if (!busy) continue;
    // this thread's sources from staged row kAxR w
    const float* sp = s + kAxR * warp * kAxLd + lane;
    if (uc == 0) {
#pragma unroll
      for (int j = 0; j < kAxG; ++j) {
#pragma unroll
        for (int r = 0; r < 8; ++r) w[j][r] = sp[(8 * j + r) * kAxLd];
      }
    }
    // whole rotations, then single steps with the window moved down
    // (in the chunk's last 8 kAxG taps or fewer), the last one 1-8 taps
    int u = 0;
    const int nc = ue - uc;
    for (; u + 8 * (kAxG + 1) <= nc; u += 8 * (kAxG + 1)) {
      axis_rotation<0>(acc, w, sp, s_t, u);
    }
    for (; u < nc; u += 8) {
#pragma unroll
      for (int r = 0; r < 8; ++r) w[kAxG][r] = sp[(u + 8 * kAxG + r) * kAxLd];
      if (u + 8 <= nc) {
        axis_step<0, false>(acc, w, s_t + u, 8);
      } else {
        axis_step<0, true>(acc, w, s_t + u, nc - u);
      }
#pragma unroll
      for (int j = 0; j < kAxG; ++j) {
#pragma unroll
        for (int r = 0; r < 8; ++r) w[j][r] = w[j + 1][r];
      }
    }
  }

  if constexpr (kRows) {
    // transpose through shared memory: a warp then stores a row's
    // outputs, adjacent lanes on adjacent addresses
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kAxG; ++g) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        s[(kAxR * warp + 8 * g + r) * kAxLd + lane] = acc[g][r];
      }
    }
    __syncthreads();
    for (int l = warp; l < 32; l += kAxWarps) {
      if (line0 + l >= lines) break;
      float* dst = out + (line0 + l) * n;
      for (int i = lane; i < kAxSeg; i += 32) {
        if (s0 + i < n) dst[s0 + i] = s[i * kAxLd + l];
      }
    }
  } else {
    if (!col_ok) return;
    float* dst = out + (col - in);
#pragma unroll
    for (int g = 0; g < kAxG; ++g) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = s0 + kAxR * warp + 8 * g + r;
        if (i < n) dst[static_cast<int64_t>(i) * inner] = acc[g][r];
      }
    }
  }
}

}  // namespace

// One 1-D convolution along ``axis`` (0: z, 1: y, 2: x) of a (nz, ny, nx)
// volume, g[i] = sum_j taps[h + i - j] f[j] over the 2h + 1 sources j
// from i - h, in ascending j.
extern "C" int visfd_blur_axis(const void* in, void* out, const void* taps,
                               int h, int nz, int ny, int nx, int axis,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(in);
  float* dst = static_cast<float*>(out);
  const float* k = static_cast<const float*>(taps);
  const dim3 block(kAxWarps * 32);
  if (axis == 2) {
    const int64_t lines = static_cast<int64_t>(nz) * ny;
    const dim3 grid(static_cast<unsigned>((lines + 31) / 32),
                    (nx + kAxSeg - 1) / kAxSeg);
    blur_axis_kernel<true><<<grid, block, 0, st>>>(src, dst, k, h, nx, 1,
                                                   lines);
  } else {
    const int n = axis == 1 ? ny : nz;
    const int outer = axis == 1 ? nz : 1;
    const int64_t inner = axis == 1 ? static_cast<int64_t>(nx)
                                    : static_cast<int64_t>(ny) * nx;
    const dim3 grid(static_cast<unsigned>((inner + 31) / 32),
                    (n + kAxSeg - 1) / kAxSeg, outer);
    blur_axis_kernel<false><<<grid, block, 0, st>>>(src, dst, k, h, n,
                                                    inner, inner);
  }
  return static_cast<int>(cudaGetLastError());
}
