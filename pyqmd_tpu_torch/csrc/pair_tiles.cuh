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
