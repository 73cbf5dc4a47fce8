// The device switch of the port's C entry points: each takes the device of
// its operands and launches there, switching only when the caller's
// current device is another one, and switching back afterwards.
#pragma once

#include <cuda_runtime.h>

// Runs `fn` (which launches and returns a CUDA error code) on `device`.
template <typename F>
static int on_device(int device, F&& fn) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = fn();
  if (prev != device) cudaSetDevice(prev);
  return rc;
}
