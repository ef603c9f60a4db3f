// The blob ladder's strict 4-D (x, y, z, sigma) extremum test and its
// sign test, for one mid scale.
//
// Replaces no Pallas kernel: the JAX package computes the test with
// XLA's elementwise minima and maxima over shifted views
// (visfd_tpu/features/blob.py, _extremum_masks).  The port's plain twin
// is features/blob._extremum_codes, whose semantics this kernel keeps:
// a voxel of the mid scale is a minimum when each of its 80 neighbours
// (the 3x3x3 boxes of the scales below and above, the 26 of its own
// scale) is larger than it, a maximum when each is smaller; a neighbour
// outside the volume, masked out (mask == 0) or NaN disqualifies the
// voxel for both tests; the comparisons are strict (a tie is no
// extremum) and a NaN centre fails both.  A minimum must also be below
// 0 and a maximum above 0 (feature.hpp:318-341).  The output is one
// byte a voxel: 1 a minimum, 2 a maximum, 0 neither; the caller
// compacts it (torch.nonzero) in raster order.
//
// What bounds it on an H100: device-memory bytes.  A voxel needs its
// three float32 scales and its mask byte read once (13 bytes) and its
// code written (1 byte), ~4 ps at 3.35 TB/s; the separable minima and
// maxima are ~50 operations a voxel.  The twin's torch passes move
// ~700 bytes a voxel through intermediates, so the design keeps every
// intermediate on the chip.
//
// Design.  A block of 32 x 8 threads owns a 32 x 32 (x, y) tile of
// output columns, 4 adjacent rows a thread, and marches in z through
// kTZ output planes.  At each step it stages one plane of the three
// scales, with a 1-voxel xy halo ((32+2) x (32+2) floats each), in
// shared memory, an invalid voxel (outside the volume, masked out) as
// NaN; the next plane's loads are issued into registers before the
// step's work, so they are in flight while it runs.  From the staged
// plane each thread takes the 3-wide minimum and maximum along x of its
// 6 rows, then along y, for the 3x3 box of every scale and the ring of
// 8 around the centre in the mid scale, and folds them into two numbers
// a plane and row: A, the box of all three scales (what a plane above
// or below the centre contributes), and B, the boxes below and above
// with the mid scale's ring (what the centre's own plane contributes).
// A voxel's 80-neighbour minimum is then min(A[z-1], B[z], A[z+1]),
// kept in registers as the march goes.  The minima and maxima propagate
// NaN (PTX min.NaN / max.NaN, as torch.minimum and torch.maximum do;
// fminf and fmaxf would drop it), so one invalid neighbour makes the
// comparison false, exactly as in the twin.
//
// Two modes, one kernel.  Whole volume (pad 0): the scales are the
// (nz, ny, nx) volumes, read in place.  Window (pad 1, a -mesh run's z
// slab of a block): the scales are the slab's windows with a 1-voxel
// halo on every face, (oz + 2, oy + 2, ox + 2), whose interior starts at
// (gz0, gy0, 0) of the (nz, ny, ox) volume; a halo voxel outside the
// volume is known by its coordinate, whatever the window holds there.
// The test is pure comparison, so both modes give every voxel the same
// code.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBX = 32;                  // tile columns: the lanes
constexpr int kRows = 8;                 // rows of threads
constexpr int kR = 4;                    // adjacent output rows a thread
constexpr int kBY = kRows * kR;          // tile rows
constexpr int kTZ = 32;                  // output planes a block
constexpr int kSX = kBX + 2;             // staged row, with the halo
constexpr int kSY = kBY + 2;             // staged rows, with the halo
constexpr int kPlane = kSX * kSY;
constexpr int kThreads = kBX * kRows;
constexpr int kPer = (kPlane + kThreads - 1) / kThreads;  // staged a thread

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__global__ void __launch_bounds__(kThreads)
    blob_extremum_kernel(const float* __restrict__ prev,
                         const float* __restrict__ mid,
                         const float* __restrict__ next,
                         const uint8_t* __restrict__ mask,
                         uint8_t* __restrict__ codes, int oz, int oy, int ox,
                         int pad, int gz0, int gy0, int nz, int ny) {
  __shared__ float s[3][kPlane];  // prev, mid, next; NaN where invalid
  const float* const src[3] = {prev, mid, next};
  const int lx = threadIdx.x, ly = threadIdx.y;
  const int tid = ly * kBX + lx;
  const int x0 = blockIdx.x * kBX, y0 = blockIdx.y * kBY;
  const int z0 = blockIdx.z * kTZ;
  const int sx = ox + 2 * pad, sy = oy + 2 * pad, sz = oz + 2 * pad;
  const int64_t splane = static_cast<int64_t>(sy) * sx;
  const float nan = __int_as_float(0x7fc00000);

  // this thread's staged voxels: their offsets in a source plane, -1
  // where a voxel lies outside the volume or the source (every plane)
  int goff[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = tid + j * kThreads;
    const int y = y0 - 1 + e / kSX, x = x0 - 1 + e % kSX;  // output coords
    const bool in = e < kPlane && gy0 + y >= 0 && gy0 + y < ny && x >= 0 &&
                    x < ox && y + pad >= 0 && y + pad < sy && x + pad < sx;
    goff[j] = in ? (y + pad) * sx + x + pad : -1;
  }

  float v[3][kPer];
  bool ok[kPer];
  auto load = [&](int p) {  // plane p of the output coordinates
    const bool zin = gz0 + p >= 0 && gz0 + p < nz && p + pad >= 0 &&
                     p + pad < sz;
    const int64_t base = static_cast<int64_t>(p + pad) * splane;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool in = zin && goff[j] >= 0;
      const int64_t i = base + goff[j];
      ok[j] = in && (mask == nullptr || mask[i] != 0);
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k][j] = in ? src[k][i] : nan;
    }
  };

  const int zo_end = min(z0 + kTZ, oz);  // output planes [z0, zo_end)
  // A (min, max) of the planes p - 2 and p - 1, B and the centre of p - 1
  float a2n[kR], a2x[kR], a1n[kR], a1x[kR], b1n[kR], b1x[kR], c1[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    a2n[q] = a2x[q] = a1n[q] = a1x[q] = b1n[q] = b1x[q] = c1[q] = nan;
  }
  load(z0 - 1);
  for (int p = z0 - 1; p <= zo_end; ++p) {
    __syncthreads();  // the last step's reads of s are done
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      if (e < kPlane) {
#pragma unroll
        for (int k = 0; k < 3; ++k) s[k][e] = ok[j] ? v[k][j] : nan;
      }
    }
    if (p < zo_end) load(p + 1);
    __syncthreads();

    // plane p: the 3x3 boxes (and the mid scale's ring of 8) of this
    // thread's kR rows, from the 3-wide minima and maxima of 6 rows
    float pn[kR], px[kR], an[kR], ax[kR], bn[kR], bx[kR], c[kR];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* sp = s[k] + ly * kR * kSX + lx;
      float rn[kR + 2], rx[kR + 2], en[kR + 2], ex[kR + 2], ctr[kR + 2];
#pragma unroll
      for (int t = 0; t < kR + 2; ++t) {
        const float l = sp[t * kSX], m = sp[t * kSX + 1], r = sp[t * kSX + 2];
        en[t] = min_nan(l, r);  // x - 1 and x + 1
        ex[t] = max_nan(l, r);
        rn[t] = min_nan(en[t], m);
        rx[t] = max_nan(ex[t], m);
        ctr[t] = m;
      }
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const float boxn = min_nan(min_nan(rn[q], rn[q + 1]), rn[q + 2]);
        const float boxx = max_nan(max_nan(rx[q], rx[q + 1]), rx[q + 2]);
        if (k == 0) {
          pn[q] = boxn;
          px[q] = boxx;
        } else if (k == 2) {
          pn[q] = min_nan(pn[q], boxn);
          px[q] = max_nan(px[q], boxx);
        } else {
          an[q] = boxn;
          ax[q] = boxx;
          bn[q] = min_nan(min_nan(rn[q], rn[q + 2]), en[q + 1]);
          bx[q] = max_nan(max_nan(rx[q], rx[q + 2]), ex[q + 1]);
          c[q] = ctr[q + 1];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      an[q] = min_nan(an[q], pn[q]);
      ax[q] = max_nan(ax[q], px[q]);
      bn[q] = min_nan(bn[q], pn[q]);
      bx[q] = max_nan(bx[q], px[q]);
    }

    // output plane p - 1: min(A[p - 2], B[p - 1], A[p]) against its centre
    const int x = x0 + lx;
    if (p > z0 && x < ox) {
      const int64_t row0 = (static_cast<int64_t>(p - 1) * oy) * ox + x;
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const int y = y0 + ly * kR + q;
        if (y < oy) {
          const float nbn = min_nan(min_nan(a2n[q], b1n[q]), an[q]);
          const float nbx = max_nan(max_nan(a2x[q], b1x[q]), ax[q]);
          const float cq = c1[q];
          const int is_min = nbn > cq && cq < 0.0f;
          const int is_max = nbx < cq && cq > 0.0f;
          codes[row0 + static_cast<int64_t>(y) * ox] =
              static_cast<uint8_t>(is_min | (is_max << 1));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      a2n[q] = a1n[q];
      a2x[q] = a1x[q];
      a1n[q] = an[q];
      a1x[q] = ax[q];
      b1n[q] = bn[q];
      b1x[q] = bx[q];
      c1[q] = c[q];
    }
  }
}

}  // namespace

// The codes (oz, oy, ox) of the mid scale; prev, mid, next (float32)
// and mask (uint8, or null: no mask) are (oz + 2 pad, oy + 2 pad,
// ox + 2 pad), contiguous; the output region starts at (gz0, gy0, 0) of
// the (nz, ny, ox) volume.  A plane of the sources must hold fewer than
// 2^31 voxels (ops-side check in features/blob).
extern "C" int visfd_blob_extremum(const void* prev, const void* mid,
                                   const void* next, const void* mask,
                                   void* codes, int oz, int oy, int ox,
                                   int pad, int gz0, int gy0, int nz, int ny,
                                   void* stream) {
  const dim3 block(kBX, kRows);
  const dim3 grid((ox + kBX - 1) / kBX, (oy + kBY - 1) / kBY,
                  (oz + kTZ - 1) / kTZ);
  blob_extremum_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), static_cast<const float*>(mid),
      static_cast<const float*>(next), static_cast<const uint8_t*>(mask),
      static_cast<uint8_t*>(codes), oz, oy, ox, pad, gz0, gy0, nz, ny);
  return static_cast<int>(cudaGetLastError());
}
