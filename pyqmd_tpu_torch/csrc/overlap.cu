// One Jacobi overlap projection, one thread block per nucleus.
//
// Replaces the TPU kernel pyqmd_tpu/kernels/overlap_pallas.py:_overlap_kernel
// (group 1 and packed groups alike); its contract is
// pyqmd_tpu_torch/core/overlap.py _resolve_once. Alive pairs closer than
// overlap_min_dist push apart by (md - max(dist, 0.001))/2 along the unit
// offset; coincident pairs push along +-(cos, sin)(u_i + u_j), + when
// i < j. Per particle the negated sum is capped at md/2 and applied to
// alive slots.
//
// What bounds it on an H100: arithmetic over P^2 pairs per nucleus
// (~15 flops, one sqrt and one division each) against 20 bytes read and
// 8 written per nucleon, as in the force kernel; it runs once per frame
// against the force kernel's once per substep. The design is the force
// kernel's: the nucleus's x, y, alive, cos u and sin u in shared memory,
// one thread per nucleon summing its full row in a fixed order. cos and
// sin are the precise cosf/sinf, once per nucleon.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_math.cuh"

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
overlap_step_kernel(const float2* __restrict__ pos, const uint8_t* __restrict__ alive,
                    const float* __restrict__ u, float2* __restrict__ out_pos, int P,
                    float md, float md2, float max_step) {
  extern __shared__ float smem[];
  float* x = smem;
  float* y = x + P;
  float* m = y + P;
  float* cu = m + P;
  float* su = cu + P;
  const size_t base = (size_t)blockIdx.x * P;

  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float2 p = pos[base + i];
    x[i] = p.x;
    y[i] = p.y;
    m[i] = alive[base + i] ? 1.0f : 0.0f;
    cu[i] = cosf(u[base + i]);
    su[i] = sinf(u[base + i]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float xi = x[i], yi = y[i];
    if (m[i] == 0.0f) {
      out_pos[base + i] = make_float2(xi, yi);
      continue;
    }
    float ax = 0.0f, ay = 0.0f;
    for (int j = 0; j < P; ++j) {
      if (j == i || m[j] == 0.0f) continue;
      const float dx = x[j] - xi;
      const float dy = y[j] - yi;
      const float dist2 = pq_dist2(dx, dy);
      if (!(dist2 < md2)) continue;
      float cs, ss, px, py;
      pq_overlap_rand_dir(cu[i], su[i], cu[j], su[j], i < j ? 1.0f : -1.0f, &cs, &ss);
      pq_overlap_push(dx, dy, dist2, cs, ss, md, &px, &py);
      ax += px;
      ay += py;
    }
    const float dx = -ax;
    const float dy = -ay;
    const float mag = sqrtf(dx * dx + dy * dy);
    const float scale = fminf(1.0f, max_step / fmaxf(mag, 1e-9f));
    out_pos[base + i] = make_float2(xi + dx * scale, yi + dy * scale);
  }
}

}  // namespace

extern "C" {

// pos/out_pos (B, P, 2) f32, alive (B, P) one byte per slot, u (B, P) f32;
// all contiguous on the device. Launches on `stream` and returns
// cudaGetLastError().
int pyqmd_overlap_step(const void* pos, const void* alive, const void* u, void* out_pos,
                       int B, int P, float md, float md2, float max_step, void* stream) {
  if (B == 0 || P == 0) return 0;
  int threads = ((P + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (size_t)5 * P * sizeof(float);
  overlap_step_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float2*)pos, (const uint8_t*)alive, (const float*)u, (float2*)out_pos, P, md,
      md2, max_step);
  return (int)cudaGetLastError();
}

}  // extern "C"
