// Shared helpers of the port's CUDA sources. Each source builds into its own
// shared library with a plain C interface (bound with ctypes), so each
// library carries its own copy of the error-string entry point.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Raise a kernel's dynamic shared-memory cap when a launch needs more than
// the default 48 KB; returns the CUDA error code (0 on success).
template <class Kernel>
inline int allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}
