// Shared by every kernel library in this directory.  Each .cu file is
// its own shared library with a plain C interface (bound with ctypes by
// the op's Python wrapper), so each one carries its own copy of these.
#pragma once

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
