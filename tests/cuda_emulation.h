// Just enough of CUDA to run a kernel's source on the CPU, one std::thread
// per CUDA thread, for tests/test_torch_kernel_emulation.py. Blocks run
// one after another; a warp's shuffles and votes meet at a barrier of its
// 32 threads and __syncthreads() at one of the block's, so warp-synchronous
// code runs as on the card. Included ahead of the kernel source, which
// the test adapts in two places: the dynamic shared array becomes
// g_smem, and `kernel<<<grid, block, smem, stream>>>(args)` becomes
// `pq_launch(kernel, grid, block, smem, stream, args)`.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __restrict__
#define __shared__ static

struct PqDim3 {
  unsigned x, y, z;
};
static thread_local PqDim3 threadIdx;
static PqDim3 blockIdx, blockDim;

struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

static std::vector<std::unique_ptr<std::barrier<>>> g_warp_barrier;
static std::unique_ptr<std::barrier<>> g_block_barrier;
static float g_lane_float[32][32];
static bool g_lane_bool[32][32];
static std::vector<char> g_smem;

inline void pq_warp_barrier() { g_warp_barrier[threadIdx.x >> 5]->arrive_and_wait(); }

// Lane `src` of the caller's group of `width` lanes (src taken modulo
// width), as CUDA defines it.
inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  g_lane_float[w][l] = v;
  pq_warp_barrier();
  const float r = g_lane_float[w][(l & ~(width - 1)) | (src & (width - 1))];
  pq_warp_barrier();
  return r;
}

// Lane l ^ mask; a lane whose source lies in a later group of `width`
// lanes keeps its own value, as CUDA defines it.
inline float __shfl_xor_sync(unsigned, float v, int mask, int width = 32) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  g_lane_float[w][l] = v;
  pq_warp_barrier();
  const int src = l ^ mask;
  const float r = src >= (l / width + 1) * width ? v : g_lane_float[w][src & 31];
  pq_warp_barrier();
  return r;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }

inline float __shfl_down_sync(unsigned mask, float v, int offset) {
  const int l = threadIdx.x & 31;
  const float r = __shfl_sync(mask, v, l + offset);
  return l + offset < 32 ? r : v;
}

inline unsigned __ballot_sync(unsigned, bool b) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  g_lane_bool[w][l] = b;
  pq_warp_barrier();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (g_lane_bool[w][i] ? 1u : 0u) << i;
  pq_warp_barrier();
  return r;
}

inline bool __any_sync(unsigned mask, bool b) { return __ballot_sync(mask, b) != 0u; }
inline void __syncwarp(unsigned = 0xffffffffu) { pq_warp_barrier(); }
inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
};
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }

template <class Kernel, class... Args>
void pq_launch(Kernel kernel, int grid, int block, size_t smem, cudaStream_t, Args... args) {
  g_smem.assign(smem, 0);
  blockDim.x = block;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    g_warp_barrier.clear();
    for (int w = 0; w < block / 32; ++w) g_warp_barrier.emplace_back(new std::barrier<>(32));
    g_block_barrier.reset(new std::barrier<>(block));
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([=] {
        threadIdx.x = t;
        kernel(args...);
      });
    }
    for (auto& t : threads) t.join();
  }
}
