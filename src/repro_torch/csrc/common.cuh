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
// the default 48 KB together with the kernel's static shared memory (at
// most 8 KB in every kernel of the port); returns the CUDA error code (0 on
// success).
template <class Kernel>
inline int allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes + 8 * 1024 <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// Asynchronous 16-byte copies from device to shared memory (cp.async, sm_80
// and later). Both addresses must be 16-byte aligned; with src_bytes = 0 the
// 16 bytes are zero-filled and nothing is read.
__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
