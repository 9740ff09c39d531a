// Fused force + integrate substep for small nuclei (P <= 32), a group of
// sub = next_pow2(P) lanes per nucleus.
//
// Replaces the lane packing of the TPU kernel
// pyqmd_tpu/kernels/forces_pallas.py:_force_kernel_packed, which packs
// 128 // P nuclei into one lane row and finds partners by lane rolls; its
// contract is pyqmd_tpu_torch/core/forces.py force_step, as for forces.cu,
// which takes P > 32.
//
// What bounds it on an H100: memory. A He-4 nucleus (P = 8, 4 alive) is 6
// pair terms against 8 x 37 bytes read and written, so the bytes set the
// least time. The tiled kernel of forces.cu gives such a nucleus a block of
// one warp, 24 of its lanes padding, with shared-memory staging, block
// barriers and a block-wide sum for a handful of pairs; a block of 32
// threads also caps an SM at half its threads. Here a warp holds 32 / sub
// nuclei and a block 256 threads: lane l owns slot l & (sub - 1) of one
// nucleus and reads its slot straight from device memory, so a warp reads
// whole consecutive nuclei in one coalesced pass. No shared memory and no
// block barrier.
//
// Each alive pair once, as the diagonal tile of pair_tiles.cuh on a group
// of sub lanes: round d = 1 .. sub/2 meets slot s with (s + d) & (sub - 1),
// the partner's position arriving by a width-sub __shfl_sync and the
// negated term going back by a second one, from (s - d) & (sub - 1).
// pq_pair_term makes the partner's share the exact negation. A round in
// which no group of the warp holds an alive pair (pq_sub_round_pairs of the
// warp's alive ballot, warp-uniform) is skipped. The alive count is the
// popcount of the group's ballot bits; the centre of mass is a width-sub
// xor butterfly, which gives every lane of the group the same bits, so two
// launches give the same result.
//
// Every lane of the grid's last warp joins every shuffle and ballot: lanes
// past the batch, and slots P .. sub-1 of a nucleus, are dead slots that
// are never loaded or stored. Fast-math follows forces.cu: approximate
// reciprocal and exp inside the pair term only, dist from pq_sqrt_rn and an
// uncontracted dist2 in both modes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_math.cuh"
#include "pair_tiles.cuh"

namespace {

constexpr int kSmallThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Sum of v over the calling lane's group of kSub lanes; every lane of the
// group gets the same bits (each step adds the same two values).
template <int kSub>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int m = kSub / 2; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m, kSub);
  return v;
}

// The pair terms on the calling lane's slot from every alive slot of its
// group, each pair met once. `alive` and `prot` are the warp's ballots.
template <bool kFast, int kSub>
__device__ __forceinline__ float2 group_pair_sum(float x, float y, uint32_t alive, uint32_t prot,
                                                 int lane, const PqForceParams& c) {
  const int s = lane & (kSub - 1);
  const int g0 = lane - s;
  const int32_t pi = (prot >> lane) & 1u;
  float aix = 0.0f, aiy = 0.0f, ajx = 0.0f, ajy = 0.0f;
#pragma unroll
  for (int d = 1; d <= kSub / 2; ++d) {
    const uint32_t pairs = pq_sub_round_pairs(alive, d, kSub);
    if (pairs == 0u) continue;  // warp-uniform
    const int src = (s + d) & (kSub - 1);
    const float xj = __shfl_sync(kFull, x, src, kSub);
    const float yj = __shfl_sync(kFull, y, src, kSub);
    const int32_t pj = (prot >> (g0 + src)) & 1u;
    float gx, gy;
    pq_pair_term(xj - x, yj - y, pi & pj, pi == pj, c, kFast, &gx, &gy);
    const bool act = (pairs >> lane) & 1u;
    gx = act ? gx : 0.0f;
    gy = act ? gy : 0.0f;
    aix += gx;
    aiy += gy;
    // Slot s is the partner of slot (s - d), whose lane computed the term.
    const int from = (s - d) & (kSub - 1);
    ajx -= __shfl_sync(kFull, gx, from, kSub);
    ajy -= __shfl_sync(kFull, gy, from, kSub);
  }
  return make_float2(aix + ajx, aiy + ajy);
}

// Pair terms plus the CoM spring on a slot at (x, y).
template <bool kFast, int kSub>
__device__ __forceinline__ float2 slot_force(float x, float y, uint32_t alive, uint32_t prot,
                                             int lane, float cx, float cy, float radius,
                                             const PqForceParams& c) {
  const float2 f = group_pair_sum<kFast, kSub>(x, y, alive, prot, lane, c);
  const float cdx = cx - x;
  const float cdy = cy - y;
  const float scale = pq_com_spring_scale(sqrtf(pq_dist2(cdx, cdy)), radius, c.com_spring);
  return make_float2(f.x + scale * cdx, f.y + scale * cdy);
}

template <bool kFast, int kSub>
__global__ void __launch_bounds__(kSmallThreads)
force_small_kernel(const float2* __restrict__ pos, const float2* __restrict__ vel,
                   const int32_t* __restrict__ ptype, const uint8_t* __restrict__ alive,
                   float2* __restrict__ out_pos, float2* __restrict__ out_vel, int64_t B, int P,
                   const float* __restrict__ dt_ptr, PqForceParams c) {
  const float dt = *dt_ptr;
  const int64_t t = (int64_t)blockIdx.x * kSmallThreads + threadIdx.x;
  const int64_t b = t / kSub;
  const int s = (int)(t & (kSub - 1));
  const int lane = threadIdx.x & 31;
  const bool valid = b < B && s < P;
  const int64_t idx = b * P + s;

  float2 p = make_float2(0.0f, 0.0f), v = make_float2(0.0f, 0.0f);
  bool a = false, prot = false;
  if (valid) {
    p = pos[idx];
    v = vel[idx];
    a = alive[idx] != 0;
    prot = a && ptype[idx] == 0;
  }
  const uint32_t alive_w = __ballot_sync(kFull, a);
  const uint32_t prot_w = __ballot_sync(kFull, prot);
  const uint32_t group = (kFull >> (32 - kSub)) << (lane & (32 - kSub));
  const float safe = fmaxf((float)__popc(alive_w & group), 1.0f);
  const float radius = pq_nuclear_radius(safe);
  float cx = group_sum<kSub>(a ? p.x : 0.0f) / safe;
  float cy = group_sum<kSub>(a ? p.y : 0.0f) / safe;

  const float2 f = slot_force<kFast, kSub>(p.x, p.y, alive_w, prot_w, lane, cx, cy, radius, c);
  if (!c.leapfrog) {
    if (!valid) return;  // after the last shuffle
    if (!a) {
      out_pos[idx] = p;
      out_vel[idx] = v;
      return;
    }
    const float nvx = (v.x + f.x * dt) * c.damping;
    const float nvy = (v.y + f.y * dt) * c.damping;
    out_vel[idx] = make_float2(nvx, nvy);
    out_pos[idx] = make_float2(p.x + nvx * dt, p.y + nvy * dt);
    return;
  }

  // Leapfrog: kick + drift of the alive slots, the CoM and a second sweep
  // at the drifted positions (forces_pallas.py:308-316), the second kick.
  const float half_dt = 0.5f * dt;
  const float vhx = v.x + f.x * half_dt;
  const float vhy = v.y + f.y * half_dt;
  const float x2 = a ? p.x + vhx * dt : p.x;
  const float y2 = a ? p.y + vhy * dt : p.y;
  cx = group_sum<kSub>(a ? x2 : 0.0f) / safe;
  cy = group_sum<kSub>(a ? y2 : 0.0f) / safe;
  const float2 f2 = slot_force<kFast, kSub>(x2, y2, alive_w, prot_w, lane, cx, cy, radius, c);
  if (!valid) return;
  if (!a) {
    out_pos[idx] = p;
    out_vel[idx] = v;
    return;
  }
  out_vel[idx] = make_float2((vhx + f2.x * half_dt) * c.damping, (vhy + f2.y * half_dt) * c.damping);
  out_pos[idx] = make_float2(x2, y2);
}

template <int kSub>
int launch_small(const void* pos, const void* vel, const void* ptype, const void* alive,
                 void* out_pos, void* out_vel, int B, int P, const void* dt,
                 const PqForceParams* params, void* stream) {
  const auto kernel =
      params->fast_math ? force_small_kernel<true, kSub> : force_small_kernel<false, kSub>;
  const int64_t threads = (int64_t)B * kSub;
  const int blocks = (int)((threads + kSmallThreads - 1) / kSmallThreads);
  kernel<<<blocks, kSmallThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)pos, (const float2*)vel, (const int32_t*)ptype, (const uint8_t*)alive,
      (float2*)out_pos, (float2*)out_vel, (int64_t)B, P, (const float*)dt, *params);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The arguments of pyqmd_force_step (forces.cu), for P <= 32; a larger P
// returns cudaErrorInvalidValue and launches nothing.
int pyqmd_force_step_small(const void* pos, const void* vel, const void* ptype,
                           const void* alive, void* out_pos, void* out_vel, int B, int P,
                           const void* dt, const PqForceParams* params, void* stream) {
  if (B == 0 || P == 0) return 0;
  if (P < 0 || P > 32) return (int)cudaErrorInvalidValue;
  const int sub = P <= 2 ? 2 : P <= 4 ? 4 : P <= 8 ? 8 : P <= 16 ? 16 : 32;
  switch (sub) {
    case 2:
      return launch_small<2>(pos, vel, ptype, alive, out_pos, out_vel, B, P, dt, params, stream);
    case 4:
      return launch_small<4>(pos, vel, ptype, alive, out_pos, out_vel, B, P, dt, params, stream);
    case 8:
      return launch_small<8>(pos, vel, ptype, alive, out_pos, out_vel, B, P, dt, params, stream);
    case 16:
      return launch_small<16>(pos, vel, ptype, alive, out_pos, out_vel, B, P, dt, params, stream);
    default:
      return launch_small<32>(pos, vel, ptype, alive, out_pos, out_vel, B, P, dt, params, stream);
  }
}

}  // extern "C"
