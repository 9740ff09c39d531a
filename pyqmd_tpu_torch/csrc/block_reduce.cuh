// Block-wide sum for kernels that run one nucleus per thread block.
#pragma once

#include <cuda_runtime.h>

// Sum of `v` over the block; every thread gets the result. blockDim.x must
// be a multiple of 32 and every thread of the block must call it. `red` is
// a __shared__ float[32].
__device__ __forceinline__ float pq_block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier call may still be reading red[0]
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) r += __shfl_down_sync(0xffffffffu, r, o);
    if (lane == 0) red[0] = r;
  }
  __syncthreads();
  return red[0];
}
