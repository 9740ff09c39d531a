// Per-nucleus arithmetic of the decay-statistics kernel (decay.cu): the
// threefry2x32 draw, the decay probability, the branch pick, the chain
// record's duration, the daughter half-life and the nucleon bitfield update.
// Every function is __host__ __device__, so the same source also compiles
// with a plain C++ compiler: the CPU tests run pq_decay_stats_nucleus over
// every nucleus and hold it to the plain PyTorch version
// (pyqmd_tpu_torch/core/decay.py, stats_only with packed_nucleons, over
// pyqmd_tpu_torch/prng.py's uniforms).
//
// Rounding follows the plain version operation by operation. Products and
// sums go through pq_mul/pq_add/pq_sub (__fmul_rn/__fadd_rn on the device),
// so nvcc cannot contract `lo + u * span` into a fused multiply-add. 2^x is
// expf(x * f32(ln 2)), as XLA lowers exp2 and as data/tables.py:exp2
// computes it; exp2f rounds differently.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#ifndef PQ_HD
#define PQ_HD __host__ __device__ __forceinline__
#endif

// Decay modes (pyqmd_tpu_torch/state.py).
enum {
  PQ_DECAY_NONE = 0,
  PQ_DECAY_ALPHA = 1,
  PQ_DECAY_BETA_MINUS = 2,
  PQ_DECAY_BETA_PLUS = 3,
  PQ_DECAY_NEUTRON_EMISSION = 5,
  PQ_DECAY_PROTON_EMISSION = 6,
};

constexpr int kPqNumDecayTypes = 8;
constexpr int kPqZDim = 128;  // data/tables.py grid
constexpr int kPqNDim = 192;
constexpr float kPqLn2Ref = 0.693f;                      // the reference's truncated ln 2
constexpr float kPqLn2 = 0.693147180559945309f;          // f32(ln 2)
constexpr float kPqLog2Of10 = 3.32192809488736235f;      // f32(log2 10)

PQ_HD float pq_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

PQ_HD float pq_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

PQ_HD float pq_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

PQ_HD float pq_fdiv(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

PQ_HD float pq_bits_to_float(uint32_t bits) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(bits);
#else
  float f;
  memcpy(&f, &bits, sizeof f);
  return f;
#endif
}

PQ_HD uint32_t pq_rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// threefry2x32 with 20 rounds, as jax.random's threefry (prng.py).
PQ_HD void pq_threefry2x32(uint32_t k1, uint32_t k2, uint32_t x1, uint32_t x2, uint32_t* o1,
                           uint32_t* o2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int i = 0; i < 5; ++i) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = pq_rotl(x2, rot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *o1 = x1;
  *o2 = x2;
}

// Element c of jax.random.uniform(key, (m,)) for any m > c: counter (0, c)
// hashed, the two words xor-ed, a mantissa under the exponent of 1.0.
PQ_HD float pq_uniform(uint32_t k1, uint32_t k2, uint32_t c) {
  uint32_t b1, b2;
  pq_threefry2x32(k1, k2, 0u, c, &b1, &b2);
  return pq_bits_to_float(((b1 ^ b2) >> 9) | 0x3F800000u) - 1.0f;
}

// Dual-regime decay probability (core/decay.py:decay_probability).
PQ_HD float pq_decay_probability(float half_life, float dt) {
  const float hl = fmaxf(half_life, 1e-30f);
  const float big = pq_sub(1.0f, expf(pq_mul(pq_fdiv(-dt, hl), kPqLn2)));
  const float small = pq_mul(pq_fdiv(kPqLn2Ref, hl), dt);
  const float p = dt > pq_mul(hl, 0.01f) ? big : small;
  return isinf(half_life) ? 0.0f : fminf(fmaxf(p, 0.0f), 1.0f);
}

// Chain-record duration: the measured time since the last decay, or an
// Exp(T/ln2) synthetic draw when it rounds to zero (nuclear_sim.py:239-255).
PQ_HD float pq_chain_duration(float time_passed, float last_decay_time, float hl, float u_dur) {
  const float measured = pq_sub(time_passed, last_decay_time);
  const bool hl_inf = isinf(hl);
  const float hl_safe = hl_inf ? 1.0f : hl;
  const float rand_factor = -logf(fmaxf(u_dur, 1e-20f));
  const float alt = measured > 0.0f ? measured : hl_safe;
  const float synth = hl_inf ? 0.0f : fminf(pq_fdiv(pq_mul(hl_safe, rand_factor), kPqLn2Ref), alt);
  return (measured < 0.001f || hl < 0.001f) ? synth : measured;
}

// Four consecutive slots of a packed data row (data/tables.py _ROWS):
// quad 0 = hl_tab, est_lo, est_span, est_scale; quad 1 = est_stable, br_p0,
// br_z0, br_n0; quad 2 = br_t0, br_z1, br_n1, br_t1. On the device a 16-byte
// load through the read-only cache; the 1.5 MB table stays in L2.
struct PqQuad {
  float x, y, z, w;
};

PQ_HD PqQuad pq_row_quad(const float* rows, int64_t cell, int quad) {
#ifdef __CUDA_ARCH__
  const float4 v = __ldg(reinterpret_cast<const float4*>(rows) + cell * 4 + quad);
  return {v.x, v.y, v.z, v.w};
#else
  const float* r = rows + cell * 16 + quad * 4;
  return {r[0], r[1], r[2], r[3]};
#endif
}

PQ_HD int64_t pq_cell(int32_t z, int32_t n) {
  const int32_t zc = z < 0 ? 0 : (z > kPqZDim - 1 ? kPqZDim - 1 : z);
  const int32_t nc = n < 0 ? 0 : (n > kPqNDim - 1 ? kPqNDim - 1 : n);
  return (int64_t)zc * kPqNDim + nc;
}

// Half-life of a daughter from its row (data/tables.py:half_life_from_row):
// tabulated, infinite when the estimator calls it stable, else
// 2^(log2(10) * (lo + u * span)) * scale.
PQ_HD float pq_half_life_from_row(PqQuad q0, float est_stable, float u) {
  const float x = pq_mul(kPqLog2Of10, pq_add(q0.y, pq_mul(u, q0.z)));
  const float est = est_stable > 0.5f ? INFINITY : pq_mul(expf(pq_mul(x, kPqLn2)), q0.w);
  return isnan(q0.x) ? est : q0.x;
}

// The lowest min(*r, popcount) set bits of x, at most two; *r drops by the
// number taken (core/decay.py:_lowest_set_bits, one word).
PQ_HD uint32_t pq_take_lowest(uint32_t x, int* r) {
  const uint32_t b1 = x & (0u - x);
  const uint32_t x2 = x ^ b1;
  const uint32_t b2 = x2 & (0u - x2);
  const uint32_t k1 = *r >= 1 ? b1 : 0u;
  *r -= k1 != 0u;
  const uint32_t k2 = *r >= 1 ? b2 : 0u;
  *r -= k2 != 0u;
  return k1 | k2;
}

// Nucleon adjustment of one decay on a nucleus's W alive/proton words
// (particles.py:149-203): alpha removes the two lowest alive protons and
// neutrons, n- and p-emission one, β- turns the first alive neutron into a
// proton and β+ the first alive proton into a neutron. The words are int64
// holding 32 bits, as the frame carries them.
PQ_HD void pq_adjust_nucleons(int64_t* alive_w, int64_t* proton_w, int words, int32_t dtype) {
  int rp = dtype == PQ_DECAY_ALPHA ? 2 : (dtype == PQ_DECAY_PROTON_EMISSION ? 1 : 0);
  int rn = dtype == PQ_DECAY_ALPHA ? 2 : (dtype == PQ_DECAY_NEUTRON_EMISSION ? 1 : 0);
  const bool bminus = dtype == PQ_DECAY_BETA_MINUS;
  const bool bplus = dtype == PQ_DECAY_BETA_PLUS;
  bool found_n = false, found_p = false;
  for (int w = 0; w < words; ++w) {
    const uint32_t a = (uint32_t)alive_w[w];
    const uint32_t p = (uint32_t)proton_w[w];
    const uint32_t ap = a & p;
    const uint32_t an = a & ~p;
    const uint32_t kill = pq_take_lowest(ap, &rp) | pq_take_lowest(an, &rn);
    const uint32_t first_n = found_n ? 0u : an & (0u - an);
    const uint32_t first_p = found_p ? 0u : ap & (0u - ap);
    found_n = found_n || an != 0u;
    found_p = found_p || ap != 0u;
    alive_w[w] = (int64_t)(a & ~kill);
    proton_w[w] = (int64_t)((p | (bminus ? first_n : 0u)) & ~(bplus ? first_p : 0u));
  }
}

// The carry of the statistics frame, nucleus-major: scalars (B,), counts
// (B, 8), bitfield words (B, W), chain rings (B, C), keys (B, 2).
struct PqDecayView {
  int32_t* z;
  int32_t* n;
  int32_t* chain_cursor;
  float* half_life;
  const float* time_passed;
  float* last_decay_time;
  int32_t* decay_counts;
  int64_t* alive_bits;
  int64_t* proton_bits;
  int32_t* chain_z0;
  int32_t* chain_n0;
  int32_t* chain_dtype;
  int32_t* chain_z1;
  int32_t* chain_n1;
  float* chain_time;
  const int64_t* keys;
  const float* rows;
  int32_t words;
  int32_t chain_cap;
  float step_time;
};

// One statistics-only decay substep of nucleus i, in place
// (core/decay.py:_apply_decay_from_draws with stats_only and
// packed_nucleons, over uniforms 0-3 of its substep key). A nucleus that
// does not decay reads its key and half-life and writes nothing.
PQ_HD void pq_decay_stats_nucleus(const PqDecayView& v, int64_t i) {
  const uint32_t k1 = (uint32_t)v.keys[2 * i];
  const uint32_t k2 = (uint32_t)v.keys[2 * i + 1];
  const float hl = v.half_life[i];
  if (!(pq_uniform(k1, k2, 0u) < pq_decay_probability(hl, v.step_time))) return;

  // Branch 1 iff u > p0 (decay_chains.py:218-229).
  const int32_t z = v.z[i], n = v.n[i];
  const int64_t cell = pq_cell(z, n);
  const PqQuad q1 = pq_row_quad(v.rows, cell, 1);
  const PqQuad q2 = pq_row_quad(v.rows, cell, 2);
  const bool pick1 = pq_uniform(k1, k2, 1u) > q1.y;
  const int32_t new_z = (int32_t)(pick1 ? q2.y : q1.z);
  const int32_t new_n = (int32_t)(pick1 ? q2.z : q1.w);
  const int32_t dtype = (int32_t)(pick1 ? q2.w : q2.x);
  if (dtype == PQ_DECAY_NONE) return;

  const float tp = v.time_passed[i];
  const float duration = pq_chain_duration(tp, v.last_decay_time[i], hl, pq_uniform(k1, k2, 2u));
  const int64_t dcell = pq_cell(new_z, new_n);
  v.half_life[i] = pq_half_life_from_row(pq_row_quad(v.rows, dcell, 0),
                                         pq_row_quad(v.rows, dcell, 1).x, pq_uniform(k1, k2, 3u));

  pq_adjust_nucleons(v.alive_bits + i * v.words, v.proton_bits + i * v.words, v.words, dtype);

  v.decay_counts[i * kPqNumDecayTypes + dtype] += 1;
  v.last_decay_time[i] = tp;
  const int32_t cursor = v.chain_cursor[i];  // never negative
  const int64_t slot = i * v.chain_cap + cursor % v.chain_cap;
  v.chain_z0[slot] = z;
  v.chain_n0[slot] = n;
  v.chain_dtype[slot] = dtype;
  v.chain_z1[slot] = new_z;
  v.chain_n1[slot] = new_n;
  v.chain_time[slot] = duration;
  v.chain_cursor[i] = cursor + 1;
  v.z[i] = new_z;
  v.n[i] = new_n;
}

// The view over the frame's carry, from the entry point's arguments (the
// order of pyqmd_decay_stats in decay.cu).
inline PqDecayView pq_decay_view(void* z, void* n, void* chain_cursor, void* half_life,
                                 const void* time_passed, void* last_decay_time,
                                 void* decay_counts, void* alive_bits, void* proton_bits,
                                 void* chain_z0, void* chain_n0, void* chain_dtype,
                                 void* chain_z1, void* chain_n1, void* chain_time,
                                 const void* keys, const void* rows, int words, int chain_cap,
                                 float step_time) {
  PqDecayView v;
  v.z = (int32_t*)z;
  v.n = (int32_t*)n;
  v.chain_cursor = (int32_t*)chain_cursor;
  v.half_life = (float*)half_life;
  v.time_passed = (const float*)time_passed;
  v.last_decay_time = (float*)last_decay_time;
  v.decay_counts = (int32_t*)decay_counts;
  v.alive_bits = (int64_t*)alive_bits;
  v.proton_bits = (int64_t*)proton_bits;
  v.chain_z0 = (int32_t*)chain_z0;
  v.chain_n0 = (int32_t*)chain_n0;
  v.chain_dtype = (int32_t*)chain_dtype;
  v.chain_z1 = (int32_t*)chain_z1;
  v.chain_n1 = (int32_t*)chain_n1;
  v.chain_time = (float*)chain_time;
  v.keys = (const int64_t*)keys;
  v.rows = (const float*)rows;
  v.words = words;
  v.chain_cap = chain_cap;
  v.step_time = step_time;
  return v;
}
