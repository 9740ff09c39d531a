// Fused force + integrate substep, one thread block per nucleus.
//
// Replaces the TPU kernels pyqmd_tpu/kernels/forces_pallas.py:_force_kernel
// and _force_kernel_packed; its contract is pyqmd_tpu_torch/core/forces.py
// force_step. For every alive nucleon it sums the clamped pair force of
// every other alive nucleon (pair_math.cuh), adds the CoM spring, and
// integrates with semi-implicit Euler (0.85 damping) or kick-drift-kick
// leapfrog. Dead slots pass through unchanged. Any capacity P works.
//
// What bounds it on an H100: arithmetic. A substep costs 2*P^2 pair
// evaluations per nucleus (one sweep; leapfrog two) of ~40 flops and 3
// transcendentals each, against 16 bytes read and written per nucleon:
// ~4*P flops per byte, far above the card's ~20 flops per byte of f32
// balance. So the design keeps the pair loop out of memory entirely: the
// nucleus's x, y, alive and is-proton sit in shared memory (4 KB at
// P = 256), each thread sums the full row of one nucleon (deterministic,
// no atomics, every thread reads the same partner so shared loads
// broadcast), and the CoM is a block reduction. The TPU kernel's
// block-antisymmetric half sweep and lane packing of small nuclei are TPU
// economies not carried over in this first form.
//
// Built without --use_fast_math; PqForceParams.fast_math selects
// approximate division inside the pair loop only. Distances keep the
// correctly rounded sqrt and an uncontracted dx^2 + dy^2 in both modes, so
// every hard threshold of the force law (dist2 >= 0.01, the cuts at 2.8, 8
// and 9) decides as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "pair_math.cuh"

namespace {

constexpr int kMaxThreads = 256;

// Alive-weighted centre of mass of (x, y) over the block's nucleus.
__device__ void block_com(const float* x, const float* y, const float* m, int P,
                          float safe_count, float* red, float* cx, float* cy) {
  float sx = 0.0f, sy = 0.0f;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    sx += x[i] * m[i];
    sy += y[i] * m[i];
  }
  *cx = pq_block_sum(sx, red) / safe_count;
  *cy = pq_block_sum(sy, red) / safe_count;
}

// Total force on alive nucleon i at positions (x, y): the pair sum plus
// the CoM spring.
__device__ void total_force(int i, const float* x, const float* y, const float* m,
                            const float* isp, int P, const PqForceParams& c, float cx,
                            float cy, float nuclear_radius, float* fx, float* fy) {
  const float xi = x[i], yi = y[i], pi = isp[i];
  float ax = 0.0f, ay = 0.0f;
  for (int j = 0; j < P; ++j) {
    if (m[j] == 0.0f) continue;
    const float dx = x[j] - xi;
    const float dy = y[j] - yi;
    const float dist2 = pq_dist2(dx, dy);
    // Self and coincident pairs drop out (nuclear_forces.py:96).
    if (dist2 < 0.01f) continue;
    // The correctly rounded sqrt in both modes: the force law's cuts test
    // dist, so it must round as the plain version's does.
    const float dist = sqrtf(dist2);
    const float f = pq_pair_force(dist, dist2, pi != 0.0f && isp[j] != 0.0f,
                                  pi == isp[j], c);
    const float g = pq_div(f, dist, c.fast_math);
    ax += g * dx;
    ay += g * dy;
  }
  const float cdx = cx - xi;
  const float cdy = cy - yi;
  const float cdist = sqrtf(pq_dist2(cdx, cdy));
  const float scale = pq_com_spring_scale(cdist, nuclear_radius, c.com_spring);
  *fx = ax + scale * cdx;
  *fy = ay + scale * cdy;
}

__global__ void __launch_bounds__(kMaxThreads)
force_step_kernel(const float2* __restrict__ pos, const float2* __restrict__ vel,
                  const int32_t* __restrict__ ptype, const uint8_t* __restrict__ alive,
                  float2* __restrict__ out_pos, float2* __restrict__ out_vel, int P,
                  float dt, PqForceParams c) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  float* x = smem;
  float* y = x + P;
  float* m = y + P;
  float* isp = m + P;
  const size_t base = (size_t)blockIdx.x * P;

  float count = 0.0f;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float2 p = pos[base + i];
    const float a = alive[base + i] ? 1.0f : 0.0f;
    x[i] = p.x;
    y[i] = p.y;
    m[i] = a;
    isp[i] = (a != 0.0f && ptype[base + i] == 0) ? 1.0f : 0.0f;  // PROTON == 0
    count += a;
  }
  // pq_block_sum synchronises the block, so the arrays are complete after.
  const float safe = fmaxf(pq_block_sum(count, red), 1.0f);
  const float radius = pq_nuclear_radius(safe);
  float cx, cy;
  block_com(x, y, m, P, safe, red, &cx, &cy);

  if (!c.leapfrog) {
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
      const float2 v = vel[base + i];
      if (m[i] == 0.0f) {
        out_pos[base + i] = make_float2(x[i], y[i]);
        out_vel[base + i] = v;
        continue;
      }
      float fx, fy;
      total_force(i, x, y, m, isp, P, c, cx, cy, radius, &fx, &fy);
      const float nvx = (v.x + fx * dt) * c.damping;
      const float nvy = (v.y + fy * dt) * c.damping;
      out_vel[base + i] = make_float2(nvx, nvy);
      out_pos[base + i] = make_float2(x[i] + nvx * dt, y[i] + nvy * dt);
    }
    return;
  }

  // Leapfrog: kick + drift into (x2, y2), then the CoM and a second
  // sweep at the drifted positions (forces_pallas.py:308-316), then the
  // second kick. The half-step velocity waits in out_vel.
  float* x2 = isp + P;
  float* y2 = x2 + P;
  const float half_dt = 0.5f * dt;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float2 v = vel[base + i];
    if (m[i] == 0.0f) {
      x2[i] = x[i];
      y2[i] = y[i];
      out_pos[base + i] = make_float2(x[i], y[i]);
      out_vel[base + i] = v;
      continue;
    }
    float fx, fy;
    total_force(i, x, y, m, isp, P, c, cx, cy, radius, &fx, &fy);
    const float vhx = v.x + fx * half_dt;
    const float vhy = v.y + fy * half_dt;
    x2[i] = x[i] + vhx * dt;
    y2[i] = y[i] + vhy * dt;
    out_vel[base + i] = make_float2(vhx, vhy);
  }
  // block_com synchronises before it reads x2/y2.
  block_com(x2, y2, m, P, safe, red, &cx, &cy);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    if (m[i] == 0.0f) continue;
    float fx, fy;
    total_force(i, x2, y2, m, isp, P, c, cx, cy, radius, &fx, &fy);
    const float2 vh = out_vel[base + i];
    out_vel[base + i] = make_float2((vh.x + fx * half_dt) * c.damping,
                                    (vh.y + fy * half_dt) * c.damping);
    out_pos[base + i] = make_float2(x2[i], y2[i]);
  }
}

}  // namespace

extern "C" {

const char* pyqmd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// pos/vel/out_pos/out_vel (B, P, 2) f32, ptype (B, P) i32, alive (B, P)
// one byte per slot; all contiguous on the device. Launches on `stream`
// and returns cudaGetLastError().
int pyqmd_force_step(const void* pos, const void* vel, const void* ptype, const void* alive,
                     void* out_pos, void* out_vel, int B, int P, float dt,
                     const PqForceParams* params, void* stream) {
  if (B == 0 || P == 0) return 0;
  int threads = ((P + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (size_t)(params->leapfrog ? 6 : 4) * P * sizeof(float);
  force_step_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float2*)pos, (const float2*)vel, (const int32_t*)ptype, (const uint8_t*)alive,
      (float2*)out_pos, (float2*)out_vel, P, dt, *params);
  return (int)cudaGetLastError();
}

}  // extern "C"
