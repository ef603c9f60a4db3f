// Voxelwise symmetric 3x3 eigen kernels.
//
// Replaces, in visfd_tpu/ops/eigen_pallas.py:
//  * _hess_eig_kernel (pallas_call in _hessian_principal_impl; entry
//    hessian_principal_pallas): blurred volume -> finite-difference
//    Hessian x sigma^2 -> principal eigensolve -> score (+ principal
//    eigenvector), faces replicating the nearest interior voxel;
//  * the same kernel with clamp=False (entry
//    hessian_principal_pallas_prepadded, the per-shard mode of a -mesh
//    run).  Here the per-shard entry reads the block in place and its
//    halos from four small slabs the caller cut from the neighbouring
//    blocks (the planes below and above it in z with their y-corner
//    rows, the rows before and after it in y), so a sharded run copies
//    no block; z and y are not clamped (the caller replicates the global
//    faces afterwards, parallel/sharded._clamp_faces_sharded), x, which
//    is never split, is clamped as on one device;
//  * _sym3_kernel (pallas_call in _sym3_score_impl; entry
//    sym3_score_pallas): channel-major 6-channel symmetric field ->
//    eigen score (+ principal eigenvector).
// Both use one solver, sym3_solve.cuh.
//
// What bounds them on an H100: instruction issue, not bytes.  The
// Hessian kernel with a score and a vector moves 20 bytes per voxel (4
// in, 16 out; ~6 ps at the H100 SXM's published 3.35 TB/s, 700 W), but
// a voxel takes 256-330 issued instructions (SASS, chip_smoke.py phase
// 1), and 132 SMs issue 4 warp instructions a clock: 8-10 ps at
// 1.98 GHz.  So the design spends no instruction it does not need:
// sym3_solve.cuh has no slow path, and the Hessian kernel does no
// integer division per voxel and reads its stencil from shared memory.
//
// Design of the Hessian kernel.  A block of 32 x 8 threads owns a 32 x 8
// (x, y) tile of output columns and marches in z through kZC outputs,
// kZT per thread and pass, so the independent solves of a pass overlap
// their latencies.  The input planes of the tile plus a 1-voxel xy halo
// ((8+2) x (32+2) floats) are staged once each, in z order, in a ring of
// shared-memory planes by cp.async, one pass ahead: a pass computes
// while the next one's planes arrive.  A voxel's stencil sits at its
// centre clamped to [1, n-2] on each clamped axis, which is the same as
// evaluating the interior and replicating it onto the faces
// (features/hessian._edge_clamp); the staged footprint is shifted at a
// volume's edge so that the clamped centre's neighbours are staged.  In
// the per-shard mode the footprint reaches one row or plane beyond the
// block in y and z, into the halo slabs, and every output voxel reads
// the same 19 operands in the same order as the single-device kernel at
// an interior voxel, so a sharded run equals the single-device one bit
// for bit.  The vote-tensor kernel is one thread per voxel: its 28 bytes
// per voxel come from six channel planes, x fastest.

#include <cuda_runtime.h>
#include <cstdint>

#include "cp_async.cuh"
#include "sym3_solve.cuh"

namespace {

constexpr int kTX = 32;               // tile x: a warp
constexpr int kTY = 8;                // tile y: warps per block
constexpr int kZT = 4;                // z outputs per thread and pass
constexpr int kZC = 32;               // z outputs per block
constexpr int kThreads = kTX * kTY;
constexpr int kSX = kTX + 2, kSY = kTY + 2;   // staged footprint
constexpr int kPlane = kSX * kSY;
constexpr int kPerThread = (kPlane + kThreads - 1) / kThreads;

// planes in the ring: a pass's kZT + 2 and the next pass's kZT, rounded
// up to a power of two so that a plane's slot is a mask
constexpr int ring_size(int n, int p = 1) {
  return p >= n ? p : ring_size(n, 2 * p);
}
constexpr int kRing = ring_size(2 * kZT + 2);

// Where the stencil's input lies.  f[z * fz + y * fy + x] for z in [0,
// nz), y in [0, ny); in the per-shard mode also the z halo planes (z =
// -1 in zlo, z = nz in zhi) at [(y + 1) * zlos + x] (zhis) for y in [-1,
// ny], and the y halo rows (y = -1 in ylo, y = ny in yhi) at [z * ylos
// + x] (yhis).
struct Source {
  const float* f;
  int64_t fz;
  int fy;
  const float* zlo;
  int zlos;
  const float* zhi;
  int zhis;
  const float* ylo;
  int64_t ylos;
  const float* yhi;
  int64_t yhis;
};

// The channels of one voxel, o pointing at its channel 0, each store
// predicated on ok (a branch around the stores cost the per-shard entry
// 3%).  The pointer steps one channel per store: with the channel
// indexed as o[(ns + c) * nvox] in an unrolled loop, nvcc 12.8 stored
// the vector of a one-channel score at channels 1, 3 and 6.
template <bool WANT_V, int FORMULA>
__device__ __forceinline__ void write_outputs(float* o, int64_t nvox,
                                              const float vals[3],
                                              const float v[3],
                                              bool ok = true) {
  float sc[3];
  visfd::score_channels<FORMULA>(vals, sc);
  constexpr int ns = visfd::n_score_channels(FORMULA);
#pragma unroll
  for (int c = 0; c < ns; ++c, o += nvox) if (ok) *o = sc[c];
  if (WANT_V) {
#pragma unroll
    for (int c = 0; c < 3; ++c, o += nvox) if (ok) *o = v[c];
  }
}

// BLOCK: the per-shard mode (halo slabs in z and y, only x clamped).
// WANT_V and the score FORMULA are compile-time: a branch on either in
// the voxel loop costs as many issue slots as a score.
template <bool BLOCK, bool WANT_V, int FORMULA>
__global__ void __launch_bounds__(kThreads, 2)
    hessian_principal_kernel(const Source src, float* __restrict__ out,
                             int nz, int ny, int nx, float s2,
                             bool decreasing) {
  __shared__ float ring[kRing][kPlane];
  const int lx = threadIdx.x, ly = threadIdx.y, tid = ly * kTX + lx;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int zc0 = blockIdx.z * kZC, zc1 = min(zc0 + kZC, nz);
  // origin of the staged footprint: one voxel before the tile, shifted
  // inwards at a clamped edge
  const int xs = max(0, min(x0 - 1, nx - kSX));
  const int ys = BLOCK ? y0 - 1 : max(0, min(y0 - 1, ny - kSY));

  auto centre_z = [&](int z) { return BLOCK ? z : min(max(z, 1), nz - 2); };
  // the highest plane a pass from z0 reads
  auto top = [&](int z0) { return centre_z(min(z0 + kZT, zc1) - 1) + 1; };
  int next = centre_z(zc0) - 1;  // the next plane to stage

  // this thread's staging elements: where element e of the next plane
  // of the block (>= 0) comes from, in the block or a y halo row, and
  // its z stride; an element with no source is zero-filled
  const float* esrc[kPerThread];
  int64_t ezs[kPerThread];
  bool eok[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = tid + k * kThreads;
    const int gy = ys + e / kSX, gx = xs + e % kSX;
    const bool in = e < kPlane && gx < nx;
    const float* row = nullptr;
    int64_t zs = 0;
    if (in && gy >= 0 && gy < ny) {
      row = src.f + static_cast<int64_t>(gy) * src.fy + gx;
      zs = src.fz;
    } else if (BLOCK && in && gy == -1) {
      row = src.ylo + gx;
      zs = src.ylos;
    } else if (BLOCK && in && gy == ny) {
      row = src.yhi + gx;
      zs = src.yhis;
    }
    eok[k] = row != nullptr;
    esrc[k] = eok[k] ? row + max(next, 0) * zs : src.f;
    ezs[k] = zs;
  }
  // plane p (-1 .. nz) into its ring slot, zeros where nothing is staged;
  // planes come in order, so each element's source moves on one plane
  auto stage = [&](int p) {
    float* dst = ring[(p + 1) & (kRing - 1)];
    if (BLOCK && (p < 0 || p >= nz)) {
      // a z halo plane, rows -1 .. ny (at most twice a block)
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int e = tid + k * kThreads;
        if (e >= kPlane) break;
        const int gy = ys + e / kSX, gx = xs + e % kSX;
        const float* g = gy > ny || gx >= nx ? nullptr
                         : p < 0 ? src.zlo + (gy + 1) * src.zlos + gx
                                 : src.zhi + (gy + 1) * src.zhis + gx;
        visfd::cp_async4(dst + e, g ? g : src.f, g != nullptr);
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (tid + k * kThreads >= kPlane) break;
      visfd::cp_async4(dst + tid + k * kThreads, esrc[k], eok[k]);
      esrc[k] += ezs[k];
    }
  };
  auto stage_to = [&](int hi) {
    for (; next <= hi; ++next) stage(next);
    visfd::cp_async_commit();
  };

  const int x = x0 + lx, y = y0 + ly;
  const bool active = x < nx && y < ny;
  // the stencil centre in the staged footprint (in range for every
  // thread, so that all of them compute and only the active ones store)
  const int cl = ((BLOCK ? y : min(max(y, 1), ny - 2)) - ys) * kSX +
                 min(max(x, 1), nx - 2) - xs;
  const int64_t nplane = static_cast<int64_t>(ny) * nx;
  const int64_t nvox = nplane * nz;
  float* const out_col = out + static_cast<int64_t>(y) * nx + x;

  stage_to(top(zc0));
  for (int z0 = zc0; z0 < zc1; z0 += kZT) {
    // the next pass's planes (none after the last pass: an empty group)
    stage_to(top(z0 + kZT));
    visfd::cp_async_wait<1>();
    // barrier: this pass's planes have landed for every thread
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kZT; ++i) {
      const int z = z0 + i;
      const int cz = centre_z(min(z, zc1 - 1));
      const float* p0 = ring[cz & (kRing - 1)] + cl;        // plane cz - 1
      const float* p1 = ring[(cz + 1) & (kRing - 1)] + cl;  // plane cz
      const float* p2 = ring[(cz + 2) & (kRing - 1)] + cl;  // plane cz + 1
      auto at = [&](int dz, int dy, int dx) {
        return (dz < 0 ? p0 : dz == 0 ? p1 : p2)[dy * kSX + dx];
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
                                               at(0, -1, 1)), at(0, 1, -1))),
                            s2);
      const float hyz = mul(mul(0.25f, sub(sub(add(at(1, 1, 0), at(-1, -1, 0)),
                                               at(-1, 1, 0)), at(1, -1, 0))),
                            s2);
      const float hxz = mul(mul(0.25f, sub(sub(add(at(1, 0, 1), at(-1, 0, -1)),
                                               at(1, 0, -1)), at(-1, 0, 1))),
                            s2);
      float vals[3], v[3];
      visfd::solve_sym3<WANT_V>(hxx, hyy, hzz, hxy, hyz, hxz, decreasing,
                                vals, v);
      write_outputs<WANT_V, FORMULA>(out_col + z * nplane, nvox, vals, v,
                                     active && z < zc1);
    }
    // barrier: every thread is done with the planes the next pass's
    // prefetch overwrites
    __syncthreads();
  }
}

template <bool WANT_V, int FORMULA>
__global__ void sym3_score_kernel(const float* __restrict__ t6,
                                  float* __restrict__ out, int64_t nvox,
                                  bool decreasing) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= nvox) return;
  // flat layout [xx, yy, zz, xy, yz, xz]
  float vals[3], v[3];
  visfd::solve_sym3<WANT_V>(t6[i], t6[nvox + i], t6[2 * nvox + i],
                            t6[3 * nvox + i], t6[4 * nvox + i],
                            t6[5 * nvox + i], decreasing, vals, v);
  write_outputs<WANT_V, FORMULA>(out + i, nvox, vals, v);
}

// The launches, with the run-time (want_v, formula) pair turned into
// template arguments by plain switches: every kernel instantiation is
// named in a function template of its own.
template <bool BLOCK, bool WANT_V, int FORMULA>
int launch_hessian3(const Source& src, float* out, int nz, int ny, int nx,
                    float s2, bool decreasing, cudaStream_t stream) {
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY,
                  (nz + kZC - 1) / kZC);
  hessian_principal_kernel<BLOCK, WANT_V, FORMULA>
      <<<grid, dim3(kTX, kTY), 0, stream>>>(src, out, nz, ny, nx, s2,
                                            decreasing);
  return static_cast<int>(cudaGetLastError());
}

template <bool BLOCK, bool WANT_V>
int launch_hessian2(const Source& src, float* out, int nz, int ny, int nx,
                    float s2, bool decreasing, int formula,
                    cudaStream_t stream) {
  switch (formula) {
    case visfd::kPlanar:
      return launch_hessian3<BLOCK, WANT_V, visfd::kPlanar>(
          src, out, nz, ny, nx, s2, decreasing, stream);
    case visfd::kLinear:
      return launch_hessian3<BLOCK, WANT_V, visfd::kLinear>(
          src, out, nz, ny, nx, s2, decreasing, stream);
    case visfd::kStick:
      return launch_hessian3<BLOCK, WANT_V, visfd::kStick>(
          src, out, nz, ny, nx, s2, decreasing, stream);
    default:
      return launch_hessian3<BLOCK, WANT_V, visfd::kVals>(
          src, out, nz, ny, nx, s2, decreasing, stream);
  }
}

template <bool BLOCK>
int launch_hessian(const Source& src, void* out, int nz, int ny, int nx,
                   float s2, int decreasing, int formula, int want_v,
                   void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return want_v ? launch_hessian2<BLOCK, true>(src, o, nz, ny, nx, s2,
                                               decreasing != 0, formula, st)
                : launch_hessian2<BLOCK, false>(src, o, nz, ny, nx, s2,
                                                decreasing != 0, formula, st);
}

constexpr int kSym3Block = 256;

template <bool WANT_V, int FORMULA>
int launch_sym3_3(const float* t6, float* out, int64_t nvox, bool decreasing,
                  cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((nvox + kSym3Block - 1) / kSym3Block);
  sym3_score_kernel<WANT_V, FORMULA>
      <<<blocks, kSym3Block, 0, stream>>>(t6, out, nvox, decreasing);
  return static_cast<int>(cudaGetLastError());
}

template <bool WANT_V>
int launch_sym3_2(const float* t6, float* out, int64_t nvox, bool decreasing,
                  int formula, cudaStream_t stream) {
  switch (formula) {
    case visfd::kPlanar:
      return launch_sym3_3<WANT_V, visfd::kPlanar>(t6, out, nvox, decreasing,
                                                   stream);
    case visfd::kLinear:
      return launch_sym3_3<WANT_V, visfd::kLinear>(t6, out, nvox, decreasing,
                                                   stream);
    case visfd::kStick:
      return launch_sym3_3<WANT_V, visfd::kStick>(t6, out, nvox, decreasing,
                                                  stream);
    default:
      return launch_sym3_3<WANT_V, visfd::kVals>(t6, out, nvox, decreasing,
                                                 stream);
  }
}

}  // namespace

// (nz, ny, nx) is the output's shape in both Hessian entries.
extern "C" int visfd_hessian_principal(const void* blur, void* out, int nz,
                                       int ny, int nx, float s2,
                                       int decreasing, int formula,
                                       int want_v, void* stream) {
  const Source src{static_cast<const float*>(blur),
                   static_cast<int64_t>(ny) * nx, nx, nullptr, 0, nullptr, 0,
                   nullptr, 0, nullptr, 0};
  return launch_hessian<false>(src, out, nz, ny, nx, s2, decreasing, formula,
                               want_v, stream);
}

// The block (nz, ny, nx) at block[z * bzs + y * bys + x]; the z halo
// planes (ny + 2, nx) at zlo[r * zlos + x] and zhi[r * zhis + x]; the y
// halo rows (nz, nx) at ylo[z * ylos + x] and yhi[z * yhis + x].
extern "C" int visfd_hessian_principal_block(
    const void* block, int64_t bzs, int bys, const void* zlo, int zlos,
    const void* zhi, int zhis, const void* ylo, int64_t ylos,
    const void* yhi, int64_t yhis, void* out, int nz, int ny, int nx,
    float s2, int decreasing, int formula, int want_v, void* stream) {
  const Source src{static_cast<const float*>(block), bzs, bys,
                   static_cast<const float*>(zlo), zlos,
                   static_cast<const float*>(zhi), zhis,
                   static_cast<const float*>(ylo), ylos,
                   static_cast<const float*>(yhi), yhis};
  return launch_hessian<true>(src, out, nz, ny, nx, s2, decreasing, formula,
                              want_v, stream);
}

extern "C" int visfd_sym3_score(const void* t6, void* out, int64_t nvox,
                                int decreasing, int formula, int want_v,
                                void* stream) {
  const float* in = static_cast<const float*>(t6);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return want_v ? launch_sym3_2<true>(in, o, nvox, decreasing != 0, formula,
                                      st)
                : launch_sym3_2<false>(in, o, nvox, decreasing != 0, formula,
                                       st);
}
