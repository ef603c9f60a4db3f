// cp.async helpers shared by the kernels that stage tiles in shared
// memory (tv.cu, eigen.cu, conv3d.cu, blur.cu's per-axis mode and wide
// instance): 4-byte copies, zero-filled when not valid, and aligned
// 16-byte copies (zero-filled when not valid, or always read).
#pragma once

namespace visfd {

__device__ __forceinline__ void cp_async4(void* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;  // 0: fill with zeros, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// both addresses 16-byte aligned; not valid: 16 zero bytes, nothing read
__device__ __forceinline__ void cp_async16(void* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace visfd
