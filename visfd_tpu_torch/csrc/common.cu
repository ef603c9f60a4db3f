// Shared C entry point of the visfd_tpu_torch kernel library: the text
// of a CUDA error code that another entry point returned.

#include <cuda_runtime.h>

extern "C" const char* visfd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
