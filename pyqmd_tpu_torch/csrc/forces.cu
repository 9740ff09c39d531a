// Fused force + integrate substep, one thread block per nucleus.
//
// Replaces the TPU kernels pyqmd_tpu/kernels/forces_pallas.py:_force_kernel
// and _force_kernel_packed; its contract is pyqmd_tpu_torch/core/forces.py
// force_step. For every alive nucleon it sums the clamped pair force of
// every other alive nucleon (pair_math.cuh), adds the CoM spring, and
// integrates with semi-implicit Euler (0.85 damping) or kick-drift-kick
// leapfrog. Dead slots pass through unchanged. Any capacity P works.
//
// What bounds it on an H100: operations, not memory. A sweep over a
// nucleus costs P(P-1)/2 pair terms of ~40 flops and 3-5 transcendentals
// (sqrt, exp, reciprocals) each, against 37 bytes read and written per
// slot; the special-function unit sets the least time, and the
// instruction issue rate (~100 instructions per warp round of 32 pairs)
// limits this form.
//
// The design evaluates each alive pair once: the pair term is antisymmetric
// (pq_pair_term), so the partner's share is the exact negation, as in the
// TPU kernel's block-antisymmetric sweep (forces_pallas.py:317-340). The
// nucleus is cut into 32-slot tiles and the warps of the block share out
// the upper triangle of tile pairs (ti <= tj), skipping a pair of tiles
// when either holds no alive slot. In a tile pair, lane l owns slot
// ti*32 + l and meets partner tj*32 + ((l + r) & 31) in round r; the
// partner's position comes by __shfl_sync from the lane that holds it, and
// the negated term goes by a second shuffle to the lane that owns the
// partner. Off the diagonal that is 32 rounds; on it rounds 1..16, with
// only lanes 0-15 acting in round 16, cover each pair once. A round that
// holds no alive pair (a warp vote on the alive bits) is skipped, which
// also makes a nucleus of a few nucleons cost a few rounds.
//
// The sums are deterministic: each warp adds its tiles' terms into a
// buffer of its own in shared memory (every slot of it written by one
// lane, in program order), and each slot's force is then the sum of the
// warps' buffers in warp order. No float atomics: the same input gives the
// same bits on every launch. Partner data sit in shared memory as one
// float4 per slot {x, y, alive, is-proton}. The CoM is a block reduction;
// the spring and the integration are per slot.
//
// Built without --use_fast_math; PqForceParams.fast_math selects
// approximate division, exp and reciprocal multiplies inside the pair
// term only. Distances keep the correctly rounded sqrt and an uncontracted
// dx^2 + dy^2 in both modes, so every hard threshold of the force law
// (dist2 >= 0.01, the cuts at 2.8, 8 and 9) decides as in the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "pair_math.cuh"
#include "pair_tiles.cuh"
#include "smem_opt_in.cuh"

namespace {

// Alive-weighted centre of mass of the slots' (x, y) over the block.
__device__ void block_com(const float4* s, int P, float safe_count, float* red, float* cx,
                          float* cy) {
  float sx = 0.0f, sy = 0.0f;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    sx += s[i].x * s[i].z;
    sy += s[i].y * s[i].z;
  }
  *cx = pq_block_sum(sx, red) / safe_count;
  *cy = pq_block_sum(sy, red) / safe_count;
}

// The pair terms of one tile pair (ti <= tj, kDiag = ti == tj) for the
// calling warp: lane l returns the sum over its partners of slot
// ti*32 + l's terms in *ax/*ay and of slot tj*32 + l's in *bx/*by (on the
// diagonal both are the same slot; the caller adds them).
template <bool kFast, bool kDiag>
__device__ void tile_pair(const float4* s, uint32_t alive_i, uint32_t alive_j,
                          uint32_t prot_i, uint32_t prot_j, int ti, int tj,
                          const PqForceParams& c, float* ax, float* ay, float* bx, float* by) {
  const int lane = threadIdx.x & 31;
  const float4 mine = s[ti * 32 + lane];
  const float4 part = s[tj * 32 + lane];
  const int32_t pi = (prot_i >> lane) & 1u;
  float aix = 0.0f, aiy = 0.0f, ajx = 0.0f, ajy = 0.0f;
  for (int r = pq_first_round(kDiag); r < pq_end_round(kDiag); ++r) {
    const uint32_t pairs = pq_round_pairs(alive_i, alive_j, r, kDiag);
    if (pairs == 0u) continue;  // warp-uniform
    const int src = (lane + r) & 31;
    const float xj = __shfl_sync(0xffffffffu, part.x, src);
    const float yj = __shfl_sync(0xffffffffu, part.y, src);
    const int32_t pj = (prot_j >> src) & 1u;
    float gx, gy;
    pq_pair_term(xj - mine.x, yj - mine.y, pi & pj, pi == pj, c, kFast, &gx, &gy);
    const bool act = (pairs >> lane) & 1u;
    gx = act ? gx : 0.0f;
    gy = act ? gy : 0.0f;
    aix += gx;
    aiy += gy;
    // Lane m owns partner slot tj*32 + m, whose term lane (m - r) computed.
    const int from = (lane - r) & 31;
    ajx -= __shfl_sync(0xffffffffu, gx, from);
    ajy -= __shfl_sync(0xffffffffu, gy, from);
  }
  *ax = aix;
  *ay = aiy;
  *bx = ajx;
  *by = ajy;
}

// One sweep: every warp adds its share of the tile pairs' terms into its
// own buffer (zeroed by the caller). The caller synchronises after.
template <bool kFast>
__device__ void pair_sweep(const float4* s, const uint32_t* alive_bits,
                           const uint32_t* prot_bits, int T, float2* buf,
                           const PqForceParams& c) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float2* mine = buf + (size_t)warp * T * 32;
  int k = 0;
  for (int ti = 0; ti < T; ++ti) {
    for (int tj = ti; tj < T; ++tj, ++k) {
      if (k % warps != warp) continue;
      if (alive_bits[ti] == 0u || alive_bits[tj] == 0u) continue;
      float ax, ay, bx, by;
      if (ti == tj) {
        tile_pair<kFast, true>(s, alive_bits[ti], alive_bits[tj], prot_bits[ti], prot_bits[tj],
                               ti, tj, c, &ax, &ay, &bx, &by);
      } else {
        tile_pair<kFast, false>(s, alive_bits[ti], alive_bits[tj], prot_bits[ti],
                                prot_bits[tj], ti, tj, c, &ax, &ay, &bx, &by);
      }
      float2& fi = mine[ti * 32 + lane];
      if (ti == tj) {
        fi.x += ax + bx;
        fi.y += ay + by;
      } else {
        fi.x += ax;
        fi.y += ay;
        float2& fj = mine[tj * 32 + lane];
        fj.x += bx;
        fj.y += by;
      }
    }
  }
}

// Total force on alive slot i: the warps' buffers summed in warp order,
// plus the CoM spring. Zeroes the slot's buffers for the next sweep.
__device__ float2 slot_force(int i, const float4& si, float2* buf, int T, int warps,
                             const PqForceParams& c, float cx, float cy,
                             float nuclear_radius) {
  float fx = 0.0f, fy = 0.0f;
  for (int w = 0; w < warps; ++w) {
    float2& b = buf[(size_t)w * T * 32 + i];
    fx += b.x;
    fy += b.y;
    b = make_float2(0.0f, 0.0f);
  }
  const float cdx = cx - si.x;
  const float cdy = cy - si.y;
  const float cdist = sqrtf(pq_dist2(cdx, cdy));
  const float scale = pq_com_spring_scale(cdist, nuclear_radius, c.com_spring);
  return make_float2(fx + scale * cdx, fy + scale * cdy);
}

// The fast kernel asks for five blocks per SM (at most 51 registers): with
// dt read from device memory nvcc gave it 54 registers, four blocks per SM
// and 2-4% more time at U-238 B=10240; with the bound it uses 48, as it did
// with dt passed by value.
template <bool kFast>
__global__ void __launch_bounds__(kPqMaxWarps * 32, kFast ? 5 : 1)
force_step_kernel(const float2* __restrict__ pos, const float2* __restrict__ vel,
                  const int32_t* __restrict__ ptype, const uint8_t* __restrict__ alive,
                  float2* __restrict__ out_pos, float2* __restrict__ out_vel, int P,
                  const float* __restrict__ dt_ptr, PqForceParams c) {
  const int T = (P + 31) / 32;
  const int warps = blockDim.x >> 5;
  extern __shared__ float4 smem[];
  float4* s = smem;                          // T*32 slots {x, y, alive, is-proton}
  float2* buf = (float2*)(s + T * 32);       // warps x T*32 partial forces
  __shared__ uint32_t alive_bits[kPqMaxTiles];
  __shared__ uint32_t prot_bits[kPqMaxTiles];
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * P;

  // A warp loads whole tiles (blockDim is a multiple of 32), so it can
  // ballot each tile's alive and proton bits as it goes. Padding slots
  // past P are dead.
  float count = 0.0f;
  for (int i = threadIdx.x; i < T * 32; i += blockDim.x) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < P) {
      const float2 p = pos[base + i];
      const float a = alive[base + i] ? 1.0f : 0.0f;
      v = make_float4(p.x, p.y, a, (a != 0.0f && ptype[base + i] == 0) ? 1.0f : 0.0f);
    }
    s[i] = v;
    count += v.z;
    for (int w = 0; w < warps; ++w) buf[(size_t)w * T * 32 + i] = make_float2(0.0f, 0.0f);
    const uint32_t a_bits = __ballot_sync(0xffffffffu, v.z != 0.0f);
    const uint32_t p_bits = __ballot_sync(0xffffffffu, v.w != 0.0f);
    if ((threadIdx.x & 31) == 0) {
      alive_bits[i >> 5] = a_bits;
      prot_bits[i >> 5] = p_bits;
    }
  }
  // pq_block_sum synchronises the block, so the slots, buffers and bits
  // are complete after it.
  const float safe = fmaxf(pq_block_sum(count, red), 1.0f);
  const float radius = pq_nuclear_radius(safe);
  float cx, cy;
  block_com(s, P, safe, red, &cx, &cy);

  pair_sweep<kFast>(s, alive_bits, prot_bits, T, buf, c);
  __syncthreads();
  const float dt = *dt_ptr;

  if (!c.leapfrog) {
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
      const float2 v = vel[base + i];
      const float4 si = s[i];
      if (si.z == 0.0f) {
        out_pos[base + i] = make_float2(si.x, si.y);
        out_vel[base + i] = v;
        continue;
      }
      const float2 f = slot_force(i, si, buf, T, warps, c, cx, cy, radius);
      const float nvx = (v.x + f.x * dt) * c.damping;
      const float nvy = (v.y + f.y * dt) * c.damping;
      out_vel[base + i] = make_float2(nvx, nvy);
      out_pos[base + i] = make_float2(si.x + nvx * dt, si.y + nvy * dt);
    }
    return;
  }

  // Leapfrog: kick + drift, with the drifted positions written over the
  // slots' own (each thread touches only its slots), then the CoM and a
  // second sweep at the drifted positions (forces_pallas.py:308-316), then
  // the second kick. The half-step velocity waits in out_vel.
  const float half_dt = 0.5f * dt;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float2 v = vel[base + i];
    const float4 si = s[i];
    if (si.z == 0.0f) {
      out_pos[base + i] = make_float2(si.x, si.y);
      out_vel[base + i] = v;
      continue;
    }
    const float2 f = slot_force(i, si, buf, T, warps, c, cx, cy, radius);
    const float vhx = v.x + f.x * half_dt;
    const float vhy = v.y + f.y * half_dt;
    s[i].x = si.x + vhx * dt;
    s[i].y = si.y + vhy * dt;
    out_vel[base + i] = make_float2(vhx, vhy);
  }
  // block_com synchronises before the sweep reads the drifted slots.
  block_com(s, P, safe, red, &cx, &cy);
  pair_sweep<kFast>(s, alive_bits, prot_bits, T, buf, c);
  __syncthreads();
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float4 si = s[i];
    if (si.z == 0.0f) continue;
    const float2 f = slot_force(i, si, buf, T, warps, c, cx, cy, radius);
    const float2 vh = out_vel[base + i];
    out_vel[base + i] = make_float2((vh.x + f.x * half_dt) * c.damping,
                                    (vh.y + f.y * half_dt) * c.damping);
    out_pos[base + i] = make_float2(si.x, si.y);
  }
}

}  // namespace

extern "C" {

const char* pyqmd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// pos/vel/out_pos/out_vel (B, P, 2) f32, ptype (B, P) i32, alive (B, P)
// one byte per slot, dt one f32; all contiguous on the device (dt is read
// by the kernel, so a captured launch reads each replay's value);
// P <= 32 * kPqMaxTiles. Launches on `stream` and returns
// cudaGetLastError().
int pyqmd_force_step(const void* pos, const void* vel, const void* ptype, const void* alive,
                     void* out_pos, void* out_vel, int B, int P, const void* dt,
                     const PqForceParams* params, void* stream) {
  static int opted[2][kPqMaxDevices];
  if (B == 0 || P == 0) return 0;
  const PqTileLaunch l = pq_tile_launch(P, sizeof(float4));
  const auto kernel = params->fast_math ? force_step_kernel<true> : force_step_kernel<false>;
  const cudaError_t err = pq_opt_in_smem(kernel, l.smem, opted[params->fast_math ? 1 : 0]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, l.warps * 32, l.smem, (cudaStream_t)stream>>>(
      (const float2*)pos, (const float2*)vel, (const int32_t*)ptype, (const uint8_t*)alive,
      (float2*)out_pos, (float2*)out_vel, P, (const float*)dt, *params);
  return (int)cudaGetLastError();
}

}  // extern "C"
