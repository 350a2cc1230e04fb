// Shared by every kernel library in this directory.  Each .cu file is
// its own shared library with a plain C interface (bound with ctypes by
// the op's Python wrapper), so each one carries its own copy of these.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

// Names a cudaError_t for the wrapper's exception message.
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch errors (too many threads, too much shared memory) never run
// and are not reported by a later synchronise: read them right away.
static inline int repro_last_error() {
  return static_cast<int>(cudaGetLastError());
}

// The current device's SM count, read from the runtime once per device
// and then kept: a launch of a few microseconds should not pay for an
// attribute query every time.
static inline cudaError_t repro_sm_count(int* sms) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) {
    *sms = cached[dev].load(std::memory_order_relaxed);
    if (*sms > 0) return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices)
    cached[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

// cp.async, for the kernels that stage tiles in shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes < 16 reads that many and fills zeros
// (0: zeros only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
