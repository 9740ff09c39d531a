// The statistics-only decay of every nucleus, one thread each: a whole
// frame of substeps per launch (pyqmd_decay_stats_frame).
//
// Replaces the TPU kernel pyqmd_tpu/kernels/decay_pallas.py:_decay_stats_kernel
// (with its _sublane_cumsum rank masks) together with the JAX frame's
// lax.scan over it (pyqmd_tpu/core/step.py:decay_ensemble_step) and the key
// tree that feeds the scan. Its contract is the port's statistics frame:
// core/decay.py:maybe_decay with stats_only and packed_nucleons, once per
// substep, under the substep keys split(split(rng, 3)[0], S). Per nucleus
// and substep: the Bernoulli draw against the dual-regime probability, the
// branch pick from the parent's packed data row, the chain record's
// duration, the nucleon bitfield update, the daughter's half-life, the
// decay counter, the last decay time and the chain-ring append. The
// arithmetic lives in decay_math.cuh.
//
// What bounds the frame form on an H100: integer work. A nucleus that does
// not decay costs 36 bytes per frame (its rng in and out, its half-life)
// and 2 + 2S threefry hashes (the frame's two splits, then a key split and
// a Bernoulli uniform per substep), ~80 integer operations each; a decay
// adds about 40 + 16 W bytes of scattered reads and writes and three more
// hashes. So the design keeps everything else off device memory: the
// frame's keys are derived in the thread and never stored, the half-life
// and its decay probability ride in registers across the substeps
// (recomputed only by a decay), the table rows are gathered
// through the read-only cache (parent row, then only the chosen daughter's
// row), and the rest of the carry is read and written in place only by a
// decay, so a frame allocates nothing but the next rng. The layout is the
// port's nucleus-major one; the per-thread ring and word accesses are
// strided, which only decaying nuclei pay.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decay_math.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    decay_stats_frame_kernel(PqDecayView v, int64_t B, int num_steps, int64_t* next_rng) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < B) pq_decay_stats_frame_nucleus(v, i, num_steps, next_rng);
}

}  // namespace

extern "C" {

// A whole frame of `num_steps` substeps. Scalars (B,) z, n, chain_cursor
// int32, half_life, time_passed, last_decay_time f32; decay_counts (B, 8)
// int32; alive/proton words (B, W) int64; chain rings (B, C) int32 x5 and
// f32; the members' frame keys `rng` (B, 2) int64, only read; `next_rng`
// (B, 2) int64 for the next frame's keys (k3[2]); rows (CELLS, 16) f32; all
// contiguous on the device. Updates the carry in place on `stream` and
// returns cudaGetLastError().
int pyqmd_decay_stats_frame(void* z, void* n, void* chain_cursor, void* half_life,
                            const void* time_passed, void* last_decay_time,
                            void* decay_counts, void* alive_bits, void* proton_bits,
                            void* chain_z0, void* chain_n0, void* chain_dtype, void* chain_z1,
                            void* chain_n1, void* chain_time, const void* rng, void* next_rng,
                            const void* rows, int B, int W, int C, float step_time,
                            int num_steps, void* stream) {
  if (B == 0) return 0;
  const PqDecayView v = pq_decay_view(z, n, chain_cursor, half_life, time_passed,
                                      last_decay_time, decay_counts, alive_bits, proton_bits,
                                      chain_z0, chain_n0, chain_dtype, chain_z1, chain_n1,
                                      chain_time, rng, rows, W, C, step_time);
  const int blocks = (B + kThreads - 1) / kThreads;
  decay_stats_frame_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      v, (int64_t)B, num_steps, (int64_t*)next_rng);
  return (int)cudaGetLastError();
}

}  // extern "C"
