// Names CUDA error codes for the Python wrappers, which raise with the name
// when a C entry point of this library returns a code other than 0.

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
