// Voxelwise symmetric 3x3 eigen kernels.
//
// Replaces, in visfd_tpu/ops/eigen_pallas.py:
//  * _hess_eig_kernel (pallas_call in _hessian_principal_impl; entry
//    hessian_principal_pallas): blurred volume -> finite-difference
//    Hessian x sigma^2 -> principal eigensolve -> score (+ principal
//    eigenvector), faces replicating the nearest interior voxel;
//  * the same kernel with clamp=False (entry
//    hessian_principal_pallas_prepadded, the per-shard mode of a -mesh
//    run): the input is a block with 1-deep halos the caller filled from
//    the neighbouring blocks, and nothing is clamped (the caller
//    replicates the global faces afterwards, ops/eigen_cuda.clamp_faces);
//  * _sym3_kernel (pallas_call in _sym3_score_impl; entry
//    sym3_score_pallas): channel-major 6-channel symmetric field ->
//    eigen score (+ principal eigenvector).
// Both use one solver, sym3_solve.cuh.
//
// What bounds them on an H100: the two bounds are close.  The Hessian
// kernel with a score and a vector moves 20 bytes per voxel (4 in, 16
// out; ~6 ps at the H100 SXM's published 3.35 TB/s, 700 W), the
// vote-tensor kernel 28 (24 in, 4 out).  The solver spends ~250
// instructions per voxel, among them IEEE divisions, sqrtf and the
// accurate atan2f, cosf and sinf (~4 ps at the published 67 TFLOP/s
// float32 rate).
//
// Design: one thread per voxel, x fastest, so every load and store of a
// warp is 32 consecutive floats; outputs are channel-major planes.  The
// Hessian kernel evaluates its 3x3x3 stencil at the voxel clamped to
// [1, n-2] on each axis, which is the same as evaluating the interior
// and replicating it onto the faces (features/hessian._edge_clamp); the
// 19 stencil reads of neighbouring threads overlap and are served by
// L1.  In the prepadded mode the input is (nz+2, ny+2, nx+2) and output
// voxel p reads the stencil centred on p + 1: the same 19 operands in
// the same order as the single-device kernel at an interior voxel, so a
// sharded run equals the single-device one bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

#include "sym3_solve.cuh"

namespace {

__device__ inline void write_outputs(float* __restrict__ out, int64_t nvox,
                                     int64_t i, const float vals[3],
                                     int formula, bool want_v,
                                     const float v[3]) {
  float sc[3];
  visfd::score_channels(vals, formula, sc);
  const int ns = visfd::n_score_channels(formula);
#pragma unroll
  for (int c = 0; c < 3; ++c) {  // unrolled: no local-memory arrays
    if (c < ns) out[c * nvox + i] = sc[c];
    if (want_v) out[(ns + c) * nvox + i] = v[c];
  }
}

__global__ void hessian_principal_kernel(const float* __restrict__ f,
                                         float* __restrict__ out, int nz,
                                         int ny, int nx, float s2,
                                         bool decreasing, int formula,
                                         bool want_v, bool prepadded) {
  const int64_t nvox = static_cast<int64_t>(nz) * ny * nx;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= nvox) return;
  const int x = static_cast<int>(i % nx);
  const int64_t zy = i / nx;
  const int y = static_cast<int>(zy % ny);
  const int z = static_cast<int>(zy / ny);
  // stencil centre (cz, cy, cx) in the input, whose rows are fy x fx
  int cz, cy, cx, fy, fx;
  if (prepadded) {
    cz = z + 1; cy = y + 1; cx = x + 1;
    fy = ny + 2; fx = nx + 2;
  } else {
    cz = min(max(z, 1), nz - 2);
    cy = min(max(y, 1), ny - 2);
    cx = min(max(x, 1), nx - 2);
    fy = ny; fx = nx;
  }
  const int64_t c0 = (static_cast<int64_t>(cz) * fy + cy) * fx + cx;
  const int64_t sz = static_cast<int64_t>(fy) * fx, sy = fx;
  auto at = [&](int dz, int dy, int dx) {
    return f[c0 + dz * sz + dy * sy + dx];
  };
  // the twin's order: ((a + b) - 2c) * s2 and (0.25 * (((a + b) - c)
  // - d)) * s2, uncontracted (see sym3_solve.cuh)
  using visfd::add;
  using visfd::mul;
  using visfd::sub;
  const float c2x = mul(2.0f, at(0, 0, 0));
  const float hxx = mul(sub(add(at(0, 0, 1), at(0, 0, -1)), c2x), s2);
  const float hyy = mul(sub(add(at(0, 1, 0), at(0, -1, 0)), c2x), s2);
  const float hzz = mul(sub(add(at(1, 0, 0), at(-1, 0, 0)), c2x), s2);
  const float hxy = mul(mul(0.25f, sub(sub(add(at(0, 1, 1), at(0, -1, -1)),
                                           at(0, -1, 1)), at(0, 1, -1))), s2);
  const float hyz = mul(mul(0.25f, sub(sub(add(at(1, 1, 0), at(-1, -1, 0)),
                                           at(-1, 1, 0)), at(1, -1, 0))), s2);
  const float hxz = mul(mul(0.25f, sub(sub(add(at(1, 0, 1), at(-1, 0, -1)),
                                           at(1, 0, -1)), at(-1, 0, 1))), s2);
  float vals[3], v[3];
  visfd::solve_sym3(hxx, hyy, hzz, hxy, hyz, hxz, decreasing, want_v,
                    vals, v);
  write_outputs(out, nvox, i, vals, formula, want_v, v);
}

__global__ void sym3_score_kernel(const float* __restrict__ t6,
                                  float* __restrict__ out, int64_t nvox,
                                  bool decreasing, int formula,
                                  bool want_v) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= nvox) return;
  // flat layout [xx, yy, zz, xy, yz, xz]
  float vals[3], v[3];
  visfd::solve_sym3(t6[i], t6[nvox + i], t6[2 * nvox + i],
                    t6[3 * nvox + i], t6[4 * nvox + i], t6[5 * nvox + i],
                    decreasing, want_v, vals, v);
  write_outputs(out, nvox, i, vals, formula, want_v, v);
}

constexpr int kThreads = 256;

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

int launch_hessian(const void* blur, void* out, int nz, int ny, int nx,
                   float s2, int decreasing, int formula, int want_v,
                   bool prepadded, void* stream) {
  const int64_t nvox = static_cast<int64_t>(nz) * ny * nx;
  hessian_principal_kernel<<<blocks_for(nvox), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blur), static_cast<float*>(out), nz, ny, nx,
      s2, decreasing != 0, formula, want_v != 0, prepadded);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (nz, ny, nx) is the output's shape in both entries; the prepadded
// input is (nz+2, ny+2, nx+2).
extern "C" int visfd_hessian_principal(const void* blur, void* out, int nz,
                                       int ny, int nx, float s2,
                                       int decreasing, int formula,
                                       int want_v, void* stream) {
  return launch_hessian(blur, out, nz, ny, nx, s2, decreasing, formula,
                        want_v, false, stream);
}

extern "C" int visfd_hessian_principal_prepadded(
    const void* blur_pad, void* out, int nz, int ny, int nx, float s2,
    int decreasing, int formula, int want_v, void* stream) {
  return launch_hessian(blur_pad, out, nz, ny, nx, s2, decreasing, formula,
                        want_v, true, stream);
}

extern "C" int visfd_sym3_score(const void* t6, void* out, int64_t nvox,
                                int decreasing, int formula, int want_v,
                                void* stream) {
  sym3_score_kernel<<<blocks_for(nvox), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t6), static_cast<float*>(out), nvox,
      decreasing != 0, formula, want_v != 0);
  return static_cast<int>(cudaGetLastError());
}
