// Small runtime helpers shared by the kernel wrappers (plain C interface,
// loaded with ctypes from csa_tpu_torch/kernels/__init__.py).
#include <cuda_runtime.h>

extern "C" const char* csa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
