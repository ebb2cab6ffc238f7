// Opting a kernel in to more than 48 KB of dynamic shared memory, shared by
// the kernels of this library.
//
// The opt-in is an attribute of the kernel on one device, so it is cached
// per (kernel, device): a launch on a device that has not seen the largest
// size yet sets it there, whichever thread launches. The mutex makes the
// check and the set one step for concurrent launches. Each kernel keeps one
// SmemOptIn beside its launcher.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

constexpr size_t kMaxSmem = 232448;  // dynamic shared memory per block on the H100, opted in

struct SmemOptIn {
  static constexpr int kDevices = 64;  // devices whose opt-in is cached
  std::mutex mu;
  size_t set_on[kDevices] = {};        // largest size set, per device
};

template <typename Kernel>
cudaError_t opt_in_smem(SmemOptIn& state, Kernel kernel, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= SmemOptIn::kDevices)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  std::lock_guard<std::mutex> lock(state.mu);
  if (smem <= state.set_on[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess) state.set_on[dev] = smem;
  return err;
}
