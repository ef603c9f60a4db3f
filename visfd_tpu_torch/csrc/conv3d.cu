// Dense (non-separable) 3-D correlation with zero padding.
//
// Replaces: visfd_tpu/ops/conv.py, _dense_conv3d_impl (XLA's
// conv_general_dilated at Precision.HIGHEST; no Pallas kernel), which
// the generalized Gaussians (-ggauss, -dogg) and -fluct with an exponent
// other than 2 run.  The wrapper (ops/dense_cuda.py) passes the kernel
// already flipped, so out[z, y, x] = sum over (a, b, c) of
// k[a, b, c] * in[z - hz + a, y - hy + b, x - hx + c], samples outside
// the volume zero.
//
// What bounds it on an H100: operations, 2 per tap (one FMA): an 11^3
// kernel is 2662 operations a voxel against 8 bytes moved.  This first
// version is the simple one: one output per thread, the taps in
// ascending (a, b, c) order, every tap read through the read-only cache
// (the same address across a warp) and every sample through L1.
//
// Invariant: every output sums all taps in that order, samples outside
// the volume entering as zeros through the same FMA, whatever the
// block; so a -mesh block read with a halo at least the kernel's
// halfwidths deep gives its interior the single-device bits.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void __launch_bounds__(256)
    conv3d_kernel(const float* __restrict__ in, float* __restrict__ out,
                  const float* __restrict__ taps, int hx, int hy, int hz,
                  int nz, int ny, int nx) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * 8 + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= nx || y >= ny) return;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int wx = 2 * hx + 1, wy = 2 * hy + 1, wz = 2 * hz + 1;
  float acc = 0.0f;
  const float* k = taps;
  for (int a = 0; a < wz; ++a) {
    const int zz = z - hz + a;
    const bool zok = zz >= 0 && zz < nz;
    for (int b = 0; b < wy; ++b) {
      const int yy = y - hy + b;
      const bool ok = zok && yy >= 0 && yy < ny;
      const float* row = in + (ok ? zz * plane + static_cast<int64_t>(yy) * nx
                                  : 0);
      for (int c = 0; c < wx; ++c, ++k) {
        const int xx = x - hx + c;
        const float v = ok && xx >= 0 && xx < nx ? __ldg(row + xx) : 0.0f;
        acc = fmaf(__ldg(k), v, acc);
      }
    }
  }
  out[z * plane + static_cast<int64_t>(y) * nx + x] = acc;
}

}  // namespace

// taps: the flipped (2hz+1, 2hy+1, 2hx+1) kernel, C order
extern "C" int visfd_conv3d(const void* in, void* out, const void* taps,
                            int hx, int hy, int hz, int nz, int ny, int nx,
                            void* stream) {
  const dim3 grid((nx + 31) / 32, (ny + 7) / 8, nz);
  conv3d_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const float*>(taps), hx, hy, hz, nz, ny, nx);
  return static_cast<int>(cudaGetLastError());
}
