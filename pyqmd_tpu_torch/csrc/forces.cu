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
// slot. The special-function unit sets the least time (six of its ops a
// pair in the fast form: 12 SM clocks a round of 32 pairs), but the
// instruction issue rate sets this kernel's pace: a pair term is ~80
// instructions on its common path, and a round's bookkeeping (the rotated
// alive masks and the skip vote, the partner's index and proton bit, its
// position by two shuffles, the negated term back by two more, the
// selects and the loop) ~25 more.
//
// The design evaluates each alive pair once: the pair term is antisymmetric
// (pq_pair_term), so the partner's share is the exact negation, as in the
// TPU kernel's block-antisymmetric sweep (forces_pallas.py:317-340). The
// nucleus is cut into 32-slot tiles, and the warps of the block run a job
// list made on the host from the tile count (pair_tiles.cuh:
// pq_force_launch) and passed by value among the kernel's parameters. A
// job meets one partner tile tj with the two row tiles ta, ta + 1 below
// it, with one row tile, or with itself (the diagonal). Lane l holds slot
// l of each row tile and meets partner slot (l + r) & 31 in round r: the
// partner's position comes by __shfl_sync once for both rows, the two pair
// terms are independent, and their negated sum goes back by one pair of
// shuffles to the lane that owns the partner. So two rows share one
// round's bookkeeping: ~185 instructions a round of two rows against ~104
// for one (sm_90a SASS), 15% off a launch at U-238 B=10240. Off the
// diagonal a job is 32 rounds; on it rounds 1..16, with only lanes 0-15
// acting in round 16, cover each pair once. A round that holds no alive
// pair (a warp vote on the alive bits) is skipped, and so is a job whose
// tiles hold none. The jobs are dealt by cost so that no warp carries more
// than the mean plus one job (at T=8 the slowest warp carries 3% more than
// the mean, against 12% with tile pairs dealt round robin); dealing them
// otherwise moved a launch by under 0.2%.
//
// The sums are deterministic: each warp adds its jobs' terms into a
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

#include <vector>

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

// The rounds of one job for the calling warp. Lane l holds slot l of each
// of its kRows row tiles (position row[k], proton bit pi[k], the tile's
// alive bits alive_i[k]) and meets partner slot l + r (mod 32) of the
// partner tile (part: lane l's own partner slot) in round r: the partner's
// position comes once by __shfl_sync for all rows, each row's term is added
// to acc[k], and the rows' negated terms, summed, go back by one shuffle
// pair to the lane that owns the partner, which returns its sum in *jx/*jy.
// On the diagonal (kDiag, one row, the partner tile itself) rounds 1..16.
template <bool kFast, bool kDiag, int kRows>
__device__ __forceinline__ void job_rounds(const float4& part, const float4 (&row)[2],
                                           const int32_t (&pi)[2],
                                           const uint32_t (&alive_i)[2], uint32_t alive_j,
                                           uint32_t prot_j, const PqForceParams& c,
                                           float2 (&acc)[2], float* jx, float* jy) {
  const int lane = threadIdx.x & 31;
  float sx = 0.0f, sy = 0.0f;
  for (int r = pq_first_round(kDiag); r < pq_end_round(kDiag); ++r) {
    uint32_t pairs[kRows];
    uint32_t any = 0u;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      pairs[k] = pq_round_pairs(alive_i[k], alive_j, r, kDiag);
      any |= pairs[k];
    }
    if (any == 0u) continue;  // warp-uniform
    const int src = (lane + r) & 31;
    const float xj = __shfl_sync(0xffffffffu, part.x, src);
    const float yj = __shfl_sync(0xffffffffu, part.y, src);
    const int32_t pj = (prot_j >> src) & 1u;
    float tx = 0.0f, ty = 0.0f;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      float gx, gy;
      pq_pair_term(xj - row[k].x, yj - row[k].y, pi[k] & pj, pi[k] == pj, c, kFast, &gx, &gy);
      const bool act = (pairs[k] >> lane) & 1u;
      gx = act ? gx : 0.0f;
      gy = act ? gy : 0.0f;
      acc[k].x += gx;
      acc[k].y += gy;
      tx = k == 0 ? gx : tx + gx;
      ty = k == 0 ? gy : ty + gy;
    }
    // Lane m owns partner slot m, whose terms lane (m - r) computed.
    const int from = (lane - r) & 31;
    sx -= __shfl_sync(0xffffffffu, tx, from);
    sy -= __shfl_sync(0xffffffffu, ty, from);
  }
  *jx = sx;
  *jy = sy;
}

// Adds the sums of the rows of job `code`, held in registers, to the
// warp's buffer. (Constant indices keep the arrays in registers.)
__device__ __forceinline__ void add_rows(float2* mine, int code, const float2 (&acc)[2]) {
  const int lane = threadIdx.x & 31;
  float2& a = mine[pq_job_row(code) * 32 + lane];
  a.x += acc[0].x;
  a.y += acc[0].y;
  if (pq_job_rows(code) == 2) {
    float2& b = mine[(pq_job_row(code) + 1) * 32 + lane];
    b.x += acc[1].x;
    b.y += acc[1].y;
  }
}

// One sweep: every warp runs its jobs (pair_tiles.cuh:pq_force_launch) and
// adds their terms into its own buffer (zeroed by the caller); each slot of
// it is written by one lane, in program order. A paired or single job's
// rows stay in registers, their sums with them, for as long as the warp's
// next job has the same rows, and are added to the buffer once. A job
// whose tiles hold no alive slot is skipped. The caller synchronises after.
template <bool kFast>
__device__ void pair_sweep(const float4* s, const uint32_t* alive_bits,
                           const uint32_t* prot_bits, int T, float2* buf,
                           const PqForceJobs& jobs, const PqForceParams& c) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float2* mine = buf + (size_t)warp * T * 32;
  int held = -1;  // the job whose rows are in registers, or -1
  float4 row[2];
  int32_t pi[2];
  uint32_t alive_i[2];
  float2 acc[2];
  for (int k = jobs.first[warp]; k < jobs.first[warp + 1]; ++k) {
    const int code = jobs.job[k];
    if (held >= 0 && !pq_job_same_rows(code, held)) {
      add_rows(mine, held, acc);
      held = -1;
    }
    const int tj = pq_job_partner(code);
    const uint32_t alive_j = alive_bits[tj];
    const float4 part = s[tj * 32 + lane];
    float jx, jy;
    if (pq_job_kind(code) == kPqJobDiag) {
      if (alive_j == 0u) continue;
      const float4 self[2] = {part, part};
      const int32_t ps[2] = {(int32_t)((prot_bits[tj] >> lane) & 1u), 0};
      const uint32_t as[2] = {alive_j, 0u};
      float2 own[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
      job_rounds<kFast, true, 1>(part, self, ps, as, alive_j, prot_bits[tj], c, own, &jx, &jy);
      float2& f = mine[tj * 32 + lane];
      f.x += own[0].x + jx;
      f.y += own[0].y + jy;
      continue;
    }
    const int rows = pq_job_rows(code);
    if (held < 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = pq_job_row(code) + (q < rows ? q : 0);
        row[q] = s[t * 32 + lane];
        pi[q] = (prot_bits[t] >> lane) & 1u;
        alive_i[q] = q < rows ? alive_bits[t] : 0u;
        acc[q] = make_float2(0.0f, 0.0f);
      }
      held = code;
    }
    if (alive_j == 0u || (alive_i[0] | alive_i[1]) == 0u) continue;
    if (rows == 2) {
      job_rounds<kFast, false, 2>(part, row, pi, alive_i, alive_j, prot_bits[tj], c, acc, &jx,
                                  &jy);
    } else {
      job_rounds<kFast, false, 1>(part, row, pi, alive_i, alive_j, prot_bits[tj], c, acc, &jx,
                                  &jy);
    }
    float2& f = mine[tj * 32 + lane];
    f.x += jx;
    f.y += jy;
  }
  if (held >= 0) add_rows(mine, held, acc);
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

// The fast kernel asks for four blocks of 8 warps per SM (at most 64
// registers): its two-row rounds then use 64 registers with no spills. At
// five blocks ptxas keeps 48 registers and spills 32 bytes, for under 1%
// less time at U-238 B=10240; at three (72-80 registers) a launch takes 8%
// longer, so more rows a lane, which would need more registers, are not
// worth their occupancy.
template <bool kFast>
__global__ void __launch_bounds__(kPqMaxWarps * 32, kFast ? 4 : 1)
force_step_kernel(const float2* __restrict__ pos, const float2* __restrict__ vel,
                  const int32_t* __restrict__ ptype, const uint8_t* __restrict__ alive,
                  float2* __restrict__ out_pos, float2* __restrict__ out_vel, int P,
                  const float* __restrict__ dt_ptr, PqForceParams c,
                  const __grid_constant__ PqForceJobs jobs) {
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

  pair_sweep<kFast>(s, alive_bits, prot_bits, T, buf, jobs, c);
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
  pair_sweep<kFast>(s, alive_bits, prot_bits, T, buf, jobs, c);
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

// The launch shape and job list of every tile count, made once.
struct ForceSchedule {
  PqForceLaunch launch;
  PqForceJobs jobs;
};

const ForceSchedule& force_schedule(int P) {
  static const std::vector<ForceSchedule> all = [] {
    std::vector<ForceSchedule> v(kPqMaxTiles + 1);
    for (int t = 1; t <= kPqMaxTiles; ++t) v[t].launch = pq_force_launch(32 * t, &v[t].jobs);
    return v;
  }();
  return all[(P + 31) / 32];
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
  const ForceSchedule& f = force_schedule(P);
  const auto kernel = params->fast_math ? force_step_kernel<true> : force_step_kernel<false>;
  const cudaError_t err = pq_opt_in_smem(kernel, f.launch.smem, opted[params->fast_math ? 1 : 0]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, f.launch.warps * 32, f.launch.smem, (cudaStream_t)stream>>>(
      (const float2*)pos, (const float2*)vel, (const int32_t*)ptype, (const uint8_t*)alive,
      (float2*)out_pos, (float2*)out_vel, P, (const float*)dt, *params, f.jobs);
  return (int)cudaGetLastError();
}

// The force kernel's schedule at capacity P (pair_tiles.cuh:pq_force_launch):
// its jobs, the paired ones among them, and its warps a block. Returns
// cudaErrorInvalidValue for a P the kernel does not take.
int pyqmd_force_schedule(int P, int* jobs, int* paired, int* warps) {
  if (P < 1 || P > 32 * kPqMaxTiles) return (int)cudaErrorInvalidValue;
  const PqForceLaunch& l = force_schedule(P).launch;
  *jobs = l.jobs;
  *paired = l.paired;
  *warps = l.warps;
  return 0;
}

}  // extern "C"
