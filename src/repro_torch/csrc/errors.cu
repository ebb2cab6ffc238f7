// Names CUDA error codes for the Python wrappers, which raise with the name
// when a C entry point of this library returns a code other than 0; and
// reads the current device's attributes, which chip_smoke.py holds
// core/roofline.py's launch limits to.

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// cudaDeviceGetAttribute(attr) of the current device, into *value.
extern "C" int repro_device_attribute(int attr, int* value) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaDeviceGetAttribute(value, static_cast<cudaDeviceAttr>(attr), dev));
}
