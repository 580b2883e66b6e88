// Name of a CUDA error code, for the Python wrappers' exceptions.

#include <cuda_runtime.h>

extern "C" const char* imagestitch_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
