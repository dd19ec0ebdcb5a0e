// What every kernel library exports besides its launch functions: the text
// of a CUDA error code, which the Python binding reads when a launch fails.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* snn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
