// Separable 3-D true convolution with zero padding, one axis per launch.
//
// Replaces: visfd_tpu/ops/blur_pallas.py, _blur_kernel (pallas_call in
// _blur3_pallas_impl; entry blur3_pallas, reached from ops/conv._sep3).
// Per axis g[i] = sum_j h[j] f[i - j], the 1-D kernel h is a runtime
// value of odd length 2*hw+1, and samples outside the volume are zero.
//
// What bounds it on an H100: device-memory bytes.  A pass does 2*hw+1
// multiply-adds per voxel and moves 8 bytes per voxel (one read, one
// write); the 2*hw neighbouring reads of a voxel are served by L1/L2.
// The three launches (z, then y, then x, the order of ops/conv._sep3)
// therefore move about 24 bytes per voxel.
//
// Design: one thread per output voxel, x fastest, so the 32 threads of
// a warp read and write 32 consecutive floats for every tap of every
// axis.  The taps are read through the read-only cache; every thread of
// a warp reads the same tap, which is a broadcast.  The TPU kernel
// fuses the three passes into one sweep (an xy-blurred plane ring that
// marches in z, 8 bytes per voxel); that fusion, with the ring in
// shared memory, is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void conv1d_axis_kernel(const float* __restrict__ in,
                                   float* __restrict__ out,
                                   const float* __restrict__ taps, int hw,
                                   int nz, int ny, int nx, int axis) {
  const int64_t nvox = static_cast<int64_t>(nz) * ny * nx;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= nvox) return;
  const int x = static_cast<int>(i % nx);
  const int64_t zy = i / nx;
  const int y = static_cast<int>(zy % ny);
  const int z = static_cast<int>(zy / ny);
  int pos, len;
  int64_t stride;
  if (axis == 0) {
    pos = z; len = nz; stride = static_cast<int64_t>(ny) * nx;
  } else if (axis == 1) {
    pos = y; len = ny; stride = nx;
  } else {
    pos = x; len = nx; stride = 1;
  }
  // g[p] = sum_t h[2hw - t] * f[p + t - hw], t ascending (the order of
  // the shift-sum twin)
  float acc = 0.0f;
  for (int t = 0; t <= 2 * hw; ++t) {
    const int q = pos + t - hw;
    if (q >= 0 && q < len) {
      acc += __ldg(&taps[2 * hw - t]) * in[i + (t - hw) * stride];
    }
  }
  out[i] = acc;
}

}  // namespace

extern "C" int visfd_conv1d_axis(const void* in, void* out,
                                 const void* taps, int hw, int nz, int ny,
                                 int nx, int axis, void* stream) {
  const int64_t nvox = static_cast<int64_t>(nz) * ny * nx;
  const int threads = 256;
  const int64_t blocks = (nvox + threads - 1) / threads;
  conv1d_axis_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const float*>(taps), hw, nz, ny, nx, axis);
  return static_cast<int>(cudaGetLastError());
}
