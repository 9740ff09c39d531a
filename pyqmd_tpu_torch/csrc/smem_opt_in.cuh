// Opting a kernel into its dynamic shared memory, once per device and size.
//
// A block may use 48 KB of shared memory, static and dynamic together,
// unless the kernel's MaxDynamicSharedMemorySize says more. The tiled
// kernels' static arrays (640 bytes in the force kernel) count too, so a
// dynamic size just under 48 KB needs the opt-in as well (the force kernel
// at P = 577-608); the launchers therefore opt in at every size, and the
// call is a no-op where it is not needed.
//
// cudaFuncSetAttribute sets a property of the kernel on the current
// device; it is no stream operation. The launchers make the call before
// their first launch at a larger size on a device and never again at that
// size, so a launch that a CUDA graph captures after a warm-up launch
// (pyqmd_tpu_torch/core/graphs.py) makes no such call inside the capture.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

constexpr int kPqMaxDevices = 64;

inline std::mutex& pq_opt_in_mutex() {
  static std::mutex mu;
  return mu;
}

// `opted` holds, per device, the largest size the kernel was opted into
// (zero-initialised by the caller, one array per kernel).
template <class Kernel>
cudaError_t pq_opt_in_smem(Kernel kernel, size_t bytes, int* opted) {
  if (bytes == 0) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(pq_opt_in_mutex());
  if (dev < kPqMaxDevices && opted[dev] >= (int)bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kPqMaxDevices) opted[dev] = (int)bytes;
  return err;
}
