// One substep of the full-physics frame's ejecta and decay for every
// nucleus, one launch: the ejecta advance and expiry, the Bernoulli decay
// check and, where it fires, the decay event with its nucleon adjustment,
// velocity damping, fragments and chain record.
//
// Replaces no TPU kernel: the JAX package runs this part of its frame as
// XLA-fused jnp inside the frame's lax.scan (pyqmd_tpu/core/step.py
// advance_ejecta, pyqmd_tpu/core/decay.py maybe_decay). The port ran it as
// ~470 PyTorch tensor ops a substep, ~9,300 small kernels of a 20-substep
// frame's CUDA graph. Its contract is the plain version,
// pyqmd_tpu_torch/core/decay.py:advance_ejecta followed by maybe_decay
// (full form, packed-row tables),
// under the substep key split(k3[:, 0], S)[:, s] of the frame's key tree,
// k3 = split(rng, 3); the kernel derives that key per nucleus.
//
// What bounds it on an H100: memory, and only the ejecta ring's. A decay is
// rare (a U-238 ensemble at 1e9 yr/s sees a few per 10,240 nuclei a
// substep), so a substep is, per nucleus, the 64-slot ring read (pos, vel,
// type, age, life, alive: 29 bytes a slot) and its pos, age and alive
// written back (13 bytes), ~2.7 KB, plus the Bernoulli uniform: two
// threefry hashes. So the design touches nothing else unless the nucleus
// decays:
//
// * A warp per nucleus, eight nuclei to a 256-thread block; lane l takes
//   ring slots l, l + 32, ..., so the nucleus-major (B, E, ...) loads and
//   stores coalesce. Every lane computes the nucleus's scalars (the key, the
//   probability, the draw, the branch) from the same loads, so the decision
//   is warp-uniform without a shuffle.
// * A nucleus that does not decay computes only uniform 0: draw element c
//   hashes counter (0, c) whatever the draw's length (core/decay.py).
// * The P-wide work runs only for a decaying nucleus: the ranks of alive
//   protons and neutrons come from a ballot and a popcount per 32-slot
//   chunk, the removal, β flips and damping are written by the slot's lane,
//   and the centre of mass is a fixed-order xor butterfly (every lane gets
//   the same bits, no float atomics). A fragment is written by the lane that
//   owns its ring slot, after that slot's advance, so no lane writes
//   another's slot; lane 0 writes the chain record, counts and scalars.
// * The frame's scalars are read from device memory (FrameScalars' vector),
//   never passed by value, so one captured graph replays at any time scale;
//   the lifetime regime is the bucket's host flag.
//
// In place: the kernel writes the fields in their tensors, and only what
// changes (the ring's pos, age and alive; a decay's fields); a caller that
// still holds the input clones it first (the frame does once a frame). The
// arithmetic rounds as the plain version does on the card, product and sum
// apart (pq_mul / pq_add), with decay_math.cuh's probability, branch row,
// duration and half-life.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decay_math.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoPi = 6.28318530717958648f;  // f32(2 pi), core/decay.py _TWO_PI

// Particle types (pyqmd_tpu_torch/state.py).
enum { kProton = 0, kNeutron = 1, kAlpha = 2, kElectron = 3, kGamma = 4, kPositron = 5 };
constexpr int kDecayGamma = 4;
constexpr int kDecayFission = 7;

}  // namespace

// The fields a substep reads and writes, nucleus-major: (B, P) nucleon
// slots, (B,) scalars, (B, 8) counts, (B, C) chain rings, (B, E) ejecta.
struct PqSubstepFields {
  float2* vel;
  uint8_t* alive;
  int32_t* ptype;
  int32_t* z;
  int32_t* n;
  float* half_life;
  int32_t* decay_counts;
  float* last_decay_time;
  int32_t* chain_z0;
  int32_t* chain_n0;
  int32_t* chain_dtype;
  int32_t* chain_z1;
  int32_t* chain_n1;
  float* chain_time;
  int32_t* chain_cursor;
  float2* ej_pos;
  float2* ej_vel;
  int32_t* ej_type;
  float* ej_age;
  float* ej_life;
  uint8_t* ej_alive;
  int32_t* ej_cursor;
};

struct PqSubstepArgs {
  PqSubstepFields f;
  const float2* pos;          // (B, P), read for the centre of mass
  const float* time_passed;   // (B,), the frame clock
  const int64_t* k3;          // (B, 3, 2), split(rng, 3)
  const float* rows;          // (CELLS, 16), data/tables.py _ROWS
  const float* step_time;     // the frame's scalars, each one f32 on the device
  const float* anim_step;
  const float* nucleon_step;
  const float* anim_age_inc;
  const float* ejecta_life;
  int64_t batch;
  int32_t particles;          // P
  int32_t ejecta;             // E
  int32_t chain;              // C
  int32_t per_event;          // cfg.max_ejecta_per_event
  int32_t step;               // s: the substep's key is split(k3[:, 0], S)[:, s]
  int32_t fast_lifetimes;     // FrameScalars.fast_lifetimes
  float decay_damping;        // cfg.decay_damping
};

namespace {

// state.py EJECTA_SPEEDS and BASE_LIFETIMES; core/decay.py _DECAY_EJECTA_TYPE.
PQ_HD float ejecta_speed(int t) {
  return t == kAlpha ? 30.0f : (t == kElectron || t == kPositron) ? 50.0f : t == kGamma ? 60.0f
                                                                                          : 40.0f;
}

PQ_HD float base_lifetime(int t) {
  return t == kAlpha ? 2.0f : (t == kElectron || t == kPositron) ? 3.0f : t == kGamma ? 1.0f
                                                                                      : INFINITY;
}

PQ_HD int decay_ejecta_type(int d) {
  switch (d) {
    case PQ_DECAY_ALPHA: return kAlpha;
    case PQ_DECAY_BETA_MINUS: return kElectron;
    case PQ_DECAY_BETA_PLUS: return kPositron;
    case kDecayGamma: return kGamma;
    case PQ_DECAY_NEUTRON_EMISSION: return kNeutron;
    case PQ_DECAY_PROTON_EMISSION: return kProton;
    case kDecayFission: return kAlpha;
    default: return 0;
  }
}

// torch.maximum: NaN if either is.
PQ_HD float maximum(float a, float b) { return (a != a || b != b) ? a + b : (a > b ? a : b); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1) v = pq_add(v, __shfl_xor_sync(kFull, v, m));
  return v;
}

// What a firing decay does to the nucleus, the same in every lane.
struct Event {
  bool eff;         // it fired and its branch is a decay
  int32_t dtype;
  int32_t new_z, new_n;
  uint32_t k1, k2;  // the substep key
};

// The nucleon adjustment, damping and centre of mass of a decay
// (core/decay.py _apply_decay_from_draws and _ejecta_updates). Returns
// the centre of mass in every lane.
__device__ __forceinline__ float2 adjust_nucleons(const PqSubstepArgs& a, int64_t i, int lane,
                                                  const Event& ev) {
  const int P = a.particles;
  const int d = ev.dtype;
  const int rm_p = d == PQ_DECAY_ALPHA ? 2 : (d == PQ_DECAY_PROTON_EMISSION ? 1 : 0);
  const int rm_n = d == PQ_DECAY_ALPHA ? 2 : (d == PQ_DECAY_NEUTRON_EMISSION ? 1 : 0);
  const bool damp = d == PQ_DECAY_ALPHA || d == PQ_DECAY_NEUTRON_EMISSION ||
                    d == PQ_DECAY_PROTON_EMISSION;
  const bool bminus = d == PQ_DECAY_BETA_MINUS, bplus = d == PQ_DECAY_BETA_PLUS;
  const uint32_t below = (1u << lane) - 1u;
  int pbase = 0, nbase = 0, count = 0;
  float sx = 0.0f, sy = 0.0f;
  for (int j0 = 0; j0 < P; j0 += 32) {  // warp-uniform trip count
    const int j = j0 + lane;
    const bool in = j < P;
    const int64_t at = i * P + j;
    const bool alive = in && a.f.alive[at] != 0;
    const int32_t t = in ? a.f.ptype[at] : -1;
    const bool isp = alive && t == kProton, isn = alive && t == kNeutron;
    const uint32_t mp = __ballot_sync(kFull, isp), mn = __ballot_sync(kFull, isn);
    const int prank = pbase + __popc(mp & below), nrank = nbase + __popc(mn & below);
    pbase += __popc(mp);
    nbase += __popc(mn);
    const bool kill = (isp && prank < rm_p) || (isn && nrank < rm_n);
    const bool alive2 = alive && !kill;
    count += __popc(__ballot_sync(kFull, alive2));
    if (!in) continue;
    const int32_t t2 = (bminus && isn && nrank == 0) ? kProton
                       : (bplus && isp && prank == 0) ? kNeutron : t;
    float2 v = a.f.vel[at];
    if (damp) v = make_float2(pq_mul(v.x, a.decay_damping), pq_mul(v.y, a.decay_damping));
    const float w = alive2 ? 1.0f : 0.0f;
    const float2 p = a.pos[at];
    sx = pq_add(sx, pq_mul(p.x, w));
    sy = pq_add(sy, pq_mul(p.y, w));
    a.f.alive[at] = alive2;
    a.f.ptype[at] = t2;
    if (damp) a.f.vel[at] = v;
  }
  const float cnt = fmaxf((float)count, 1.0f);
  return make_float2(pq_fdiv(warp_sum(sx), cnt), pq_fdiv(warp_sum(sy), cnt));
}

// The ring's advance and expiry for the lane's slots (core/step.py
// advance_ejecta), then the event's fragments into ring slots
// (ej_cursor + k) mod E, k < n_active, at the centre of mass.
__device__ __forceinline__ void advance_ring(const PqSubstepArgs& a, int64_t i, int lane,
                                             const Event& ev, int n_active, bool fission,
                                             float2 com) {
  const int E = a.ejecta;
  const float anim_step = *a.anim_step, nucleon_step = *a.nucleon_step;
  const float anim_inc = *a.anim_age_inc, step_time = *a.step_time;
  const float life_new = *a.ejecta_life;
  const int64_t cursor = a.f.ej_cursor[i];
  const int k_e = a.per_event;
  for (int s = lane; s < E; s += 32) {
    const int64_t at = i * E + s;
    int32_t type = a.f.ej_type[at];
    float2 pos = a.f.ej_pos[at];
    float2 vel = a.f.ej_vel[at];
    float age = a.f.ej_age[at];
    float life = a.f.ej_life[at];
    const bool live = a.f.ej_alive[at] != 0;
    const bool anim = type >= kAlpha;
    const float step = live ? (anim ? anim_step : nucleon_step) : 0.0f;
    pos = make_float2(pq_add(pos.x, pq_mul(vel.x, step)), pq_add(pos.y, pq_mul(vel.y, step)));
    age = pq_add(age, live ? (anim ? anim_inc : step_time) : 0.0f);
    bool alive = live && !(anim && age >= life);
    bool frag = false;
    if (n_active > 0) {
      int64_t rel = ((int64_t)s - cursor) % E;
      if (rel < 0) rel += E;
      if (rel < n_active) {
        // Fragment k lands in slot (cursor + k) mod E for k < E only: a
        // ring smaller than an event keeps its first E fragments.
        const int k = (int)rel;
        type = fission ? (pq_uniform(ev.k1, ev.k2, 5u + k) < 0.7f ? kAlpha : kNeutron)
                       : decay_ejecta_type(ev.dtype);
        const float ang = pq_mul(pq_uniform(ev.k1, ev.k2, 5u + k_e + k), kTwoPi);
        const float speed = ejecta_speed(type);
        pos = com;
        vel = make_float2(pq_mul(speed, cosf(ang)), pq_mul(speed, sinf(ang)));
        age = 0.0f;
        life = a.fast_lifetimes ? life_new : maximum(base_lifetime(type), life_new);
        alive = true;
        frag = true;
      }
    }
    a.f.ej_pos[at] = pos;
    a.f.ej_age[at] = age;
    a.f.ej_alive[at] = alive;
    if (frag) {
      a.f.ej_vel[at] = vel;
      a.f.ej_type[at] = type;
      a.f.ej_life[at] = life;
    }
  }
}

__global__ void __launch_bounds__(kThreads) ejecta_decay_substep_kernel(PqSubstepArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= a.batch) return;  // the whole warp
  const PqSubstepFields& f = a.f;

  // The Bernoulli check (core/decay.py maybe_decay): uniform 0 of the
  // substep key against the dual-regime probability.
  Event ev;
  pq_split_key((uint32_t)a.k3[6 * i], (uint32_t)a.k3[6 * i + 1], (uint32_t)a.step, &ev.k1,
               &ev.k2);
  const float hl = f.half_life[i];
  const bool did = pq_uniform(ev.k1, ev.k2, 0u) < pq_decay_probability(hl, *a.step_time);
  const int32_t z = f.z[i], n = f.n[i];
  ev.eff = false;
  ev.dtype = PQ_DECAY_NONE;
  ev.new_z = ev.new_n = 0;
  if (did) {  // branch 1 iff u > p0 (decay_chains.py:218-229)
    const int64_t cell = pq_cell(z, n);
    const PqQuad q1 = pq_row_quad(a.rows, cell, 1);
    const PqQuad q2 = pq_row_quad(a.rows, cell, 2);
    const bool pick1 = pq_uniform(ev.k1, ev.k2, 1u) > q1.y;
    ev.new_z = (int32_t)(pick1 ? q2.y : q1.z);
    ev.new_n = (int32_t)(pick1 ? q2.z : q1.w);
    ev.dtype = (int32_t)(pick1 ? q2.w : q2.x);
    ev.eff = ev.dtype != PQ_DECAY_NONE;
  }

  float2 com = make_float2(0.0f, 0.0f);
  if (ev.eff) com = adjust_nucleons(a, i, lane, ev);

  int n_active = 0;
  const bool fission = ev.dtype == kDecayFission;
  if (ev.eff) {  // randint(2, 3) fragments for fission (decay_chains.py:377), else 1
    const int nfrag = fission ? 2 + (pq_uniform(ev.k1, ev.k2, 4u) < 0.5f) : 1;
    n_active = nfrag < a.per_event ? nfrag : a.per_event;
  }
  advance_ring(a, i, lane, ev, n_active, fission, com);

  // The chain record, counters and scalars, by lane 0 once every lane has
  // read the scalars it overwrites.
  __syncwarp();
  if (lane != 0) return;
  if (ev.eff) {
    const int32_t cursor = f.chain_cursor[i];  // never negative
    const int64_t at = i * a.chain + cursor % a.chain;
    f.chain_z0[at] = z;
    f.chain_n0[at] = n;
    f.chain_dtype[at] = ev.dtype;
    f.chain_z1[at] = ev.new_z;
    f.chain_n1[at] = ev.new_n;
    f.chain_time[at] = pq_chain_duration(a.time_passed[i], f.last_decay_time[i], hl,
                                         pq_uniform(ev.k1, ev.k2, 2u));
    f.decay_counts[i * kPqNumDecayTypes + ev.dtype] += 1;
    const int64_t dcell = pq_cell(ev.new_z, ev.new_n);
    f.half_life[i] = pq_half_life_from_row(pq_row_quad(a.rows, dcell, 0),
                                           pq_row_quad(a.rows, dcell, 1).x,
                                           pq_uniform(ev.k1, ev.k2, 3u));
    f.z[i] = ev.new_z;
    f.n[i] = ev.new_n;
    f.last_decay_time[i] = a.time_passed[i];
    f.chain_cursor[i] = cursor + 1;
  }
  if (n_active > 0) f.ej_cursor[i] += n_active;
}

}  // namespace

extern "C" {

// Every pointer of `args` contiguous on the device. Launches on `stream`
// and returns cudaGetLastError().
int pyqmd_ejecta_decay_substep(const PqSubstepArgs* args, void* stream) {
  if (args->batch == 0) return 0;
  const int blocks = (int)((args->batch + kWarps - 1) / kWarps);
  ejecta_decay_substep_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // extern "C"
