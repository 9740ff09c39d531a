// The tile schedule shared by the force and overlap kernels: a nucleus of
// P slots is cut into T = ceil(P / 32) tiles of 32, and a warp meets the
// pairs of a tile pair (ti <= tj) in rounds, lane l of tile ti against
// lane (l + r) & 31 of tile tj in round r; the small-nucleus kernel runs
// the diagonal tile on groups of fewer lanes. Plain integer arithmetic, so
// the CPU tests compile it with g++ and check that the rounds meet every
// pair of alive slots once.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "pair_math.cuh"

constexpr int kPqMaxWarps = 8;   // warps per block (one nucleus)
constexpr int kPqMaxTiles = 64;  // P <= 2048
// Dynamic shared memory a block may take: Hopper's 232,448 bytes per
// block (opt-in above 48 KB) less 1 KB for the kernels' static arrays.
constexpr size_t kPqMaxSharedBytes = 232448 - 1024;

// Rounds of a tile pair: 0..31 off the diagonal, 1..16 on it.
PQ_HD int pq_first_round(bool diag) { return diag ? 1 : 0; }
PQ_HD int pq_end_round(bool diag) { return diag ? 17 : 32; }

// Bit l set where lane l of the i-tile and lane (l + r) & 31 of the j-tile
// are both alive in round r: alive_i & (alive_j rotated right by r). On the
// diagonal, round 16 meets lanes l and l + 16 from both ends, so only
// lanes 0-15 act.
PQ_HD uint32_t pq_round_pairs(uint32_t alive_i, uint32_t alive_j, int r, bool diag) {
  const uint32_t rot = r == 0 ? alive_j : (alive_j >> r) | (alive_j << (32 - r));
  const uint32_t pairs = alive_i & rot;
  return (diag && r == 16) ? (pairs & 0xffffu) : pairs;
}

// The sub-warp schedule of the small-nucleus kernel (forces_small.cu): a
// warp holds 32 / sub nuclei, lane l = g0 + s holding slot s of the nucleus
// at group g0, and round d = 1 .. sub/2 meets slot s with slot
// (s + d) & (sub - 1): the diagonal tile of size `sub`. Bit l is set where
// both slots are alive; in round sub/2 the pair (s, s + sub/2) would be met
// from both ends, so only the lower half of each group acts.
PQ_HD uint32_t pq_group_bits(int sub, int lo, int hi) {
  // Bits lo..hi-1 of every group of `sub` lanes (sub < 32).
  return (((1u << (hi - lo)) - 1u) << lo) * (0xFFFFFFFFu / ((1u << sub) - 1u));
}

PQ_HD uint32_t pq_sub_round_pairs(uint32_t alive, int d, int sub) {
  if (sub == 32) return pq_round_pairs(alive, alive, d, true);
  // Each group rotated right by d: slot s sees slot (s + d) mod sub.
  const uint32_t near = pq_group_bits(sub, 0, sub - d);
  const uint32_t rot = ((alive >> d) & near) | ((alive << (sub - d)) & ~near);
  const uint32_t pairs = alive & rot;
  return 2 * d == sub ? pairs & pq_group_bits(sub, 0, sub / 2) : pairs;
}

struct PqTileLaunch {
  int warps;    // warps per block
  size_t smem;  // dynamic shared memory: T*32 slots, then warps x T*32 float2
};

// Launch shape for capacity P with `slot_bytes` of partner data per slot:
// one warp per tile pair up to kPqMaxWarps, fewer where the per-warp force
// buffers would not fit in shared memory.
inline PqTileLaunch pq_tile_launch(int P, size_t slot_bytes) {
  const int T = (P + 31) / 32;
  const int tile_pairs = T * (T + 1) / 2;
  PqTileLaunch l;
  l.warps = tile_pairs < kPqMaxWarps ? tile_pairs : kPqMaxWarps;
  const size_t slots = (size_t)T * 32;
  for (;;) {
    l.smem = slots * slot_bytes + (size_t)l.warps * slots * 2 * sizeof(float);
    if (l.smem <= kPqMaxSharedBytes || l.warps == 1) return l;
    --l.warps;
  }
}

// The force kernel's schedule (forces.cu), a job list made on the host from
// T alone. A job is one partner tile tj met by one or two row tiles below
// it, or a diagonal tile:
//   - paired: rows ta and ta + 1 < tj, 32 rounds; lane l holds both rows'
//     slots and meets partner tj*32 + ((l + r) & 31) once for both;
//   - single: row ta < tj, 32 rounds;
//   - diag: tile tj against itself, rounds 1..16.
// Under each tj the row tiles below it pair up as (0, 1), (2, 3), ...; an
// odd one out, tj - 1, is a single job. So T tiles give T diagonal jobs and
// floor(T^2 / 4) others, and paired jobs exist from T = 3 on. A job is one
// 16-bit code, kind << 12 | ta << 6 | tj, and codes sort a warp's jobs so
// that paired jobs on the same rows follow each other (the kernel keeps
// those rows' sums in registers across them).
enum PqJobKind { kPqJobPaired = 0, kPqJobSingle = 1, kPqJobDiag = 2 };
constexpr int kPqMaxForceJobs = kPqMaxTiles + kPqMaxTiles * kPqMaxTiles / 4;

PQ_HD int pq_job_code(int kind, int ta, int tj) { return kind << 12 | ta << 6 | tj; }
PQ_HD int pq_job_kind(int code) { return code >> 12; }
PQ_HD int pq_job_row(int code) { return (code >> 6) & 63; }
PQ_HD int pq_job_partner(int code) { return code & 63; }
PQ_HD int pq_job_rows(int code) { return pq_job_kind(code) == kPqJobPaired ? 2 : 1; }
// Whether two jobs are of one kind on the same row tiles.
PQ_HD bool pq_job_same_rows(int a, int b) { return (a >> 6) == (b >> 6); }

// What a job costs a warp, in quarters of a one-row round: a round of two
// rows shares its partner's shuffles, index arithmetic, masks and loop,
// and issues ~7/4 of a one-row round's instructions (the SASS of the
// force kernel on sm_90a: ~185 against ~104 on the path without the hard
// core).
PQ_HD int pq_job_cost(int code) {
  const int kind = pq_job_kind(code);
  return kind == kPqJobDiag ? 16 * 4 : kind == kPqJobSingle ? 32 * 4 : 32 * 7;
}

// The job list as the kernel takes it, by value in its parameters: warp w
// runs job[first[w]] .. job[first[w + 1] - 1] in order.
struct PqForceJobs {
  uint16_t first[kPqMaxWarps + 1];
  uint16_t job[kPqMaxForceJobs];
};

struct PqForceLaunch {
  int warps;    // warps per block
  size_t smem;  // dynamic shared memory: T*32 float4 slots, then the warps' buffers
  int jobs;     // jobs in the list
  int paired;   // paired jobs among them
};

// Launch shape and job list for capacity P. Warps: one per job up to
// kPqMaxWarps, fewer where their force buffers would not fit in shared
// memory. The deal: jobs in order of cost, most costly first, each to the
// warp with the least cost so far (the lowest such warp), so that no warp
// carries more than the mean plus one job; then each warp's jobs in code
// order.
inline PqForceLaunch pq_force_launch(int P, PqForceJobs* out) {
  const int T = (P + 31) / 32;
  int codes[kPqMaxForceJobs];
  int n = 0;
  for (int tj = 0; tj < T; ++tj)
    for (int ta = 0; ta + 1 < tj; ta += 2) codes[n++] = pq_job_code(kPqJobPaired, ta, tj);
  PqForceLaunch l;
  l.paired = n;
  for (int tj = 1; tj < T; tj += 2) codes[n++] = pq_job_code(kPqJobSingle, tj - 1, tj);
  for (int tj = 0; tj < T; ++tj) codes[n++] = pq_job_code(kPqJobDiag, tj, tj);
  l.jobs = n;
  l.warps = n < kPqMaxWarps ? n : kPqMaxWarps;
  const size_t slots = (size_t)T * 32;
  for (;;) {
    l.smem = slots * 4 * sizeof(float) + (size_t)l.warps * slots * 2 * sizeof(float);
    if (l.smem <= kPqMaxSharedBytes || l.warps == 1) break;
    --l.warps;
  }
  int load[kPqMaxWarps] = {0};
  int warp_of[kPqMaxForceJobs];
  for (int k = 0; k < n; ++k) {  // codes are in order of cost already
    int w = 0;
    for (int v = 1; v < l.warps; ++v) w = load[v] < load[w] ? v : w;
    warp_of[k] = w;
    load[w] += pq_job_cost(codes[k]);
  }
  int m = 0;
  for (int w = 0; w < l.warps; ++w) {
    out->first[w] = (uint16_t)m;
    const int start = m;
    for (int k = 0; k < n; ++k) {
      if (warp_of[k] != w) continue;
      int at = m++;  // insertion in code order
      for (; at > start && out->job[at - 1] > codes[k]; --at) out->job[at] = out->job[at - 1];
      out->job[at] = (uint16_t)codes[k];
    }
  }
  for (int w = l.warps; w <= kPqMaxWarps; ++w) out->first[w] = (uint16_t)m;
  return l;
}
