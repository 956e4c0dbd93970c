// Small runtime helpers shared by the kernel wrappers (plain C interface,
// loaded with ctypes from csa_tpu_torch/kernels/__init__.py).
#include <cuda_runtime.h>

extern "C" const char* csa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Largest dynamic shared memory a block may opt into on the current device.
extern "C" int csa_smem_optin(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}
