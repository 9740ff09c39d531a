// One statistics-only decay substep for every nucleus, one thread each.
//
// Replaces the TPU kernel pyqmd_tpu/kernels/decay_pallas.py:_decay_stats_kernel
// (with its _sublane_cumsum rank masks); its contract is
// pyqmd_tpu_torch/core/decay.py:maybe_decay with stats_only and
// packed_nucleons. Per nucleus: the Bernoulli draw against the dual-regime
// probability, the branch pick from the parent's packed data row, the chain
// record's duration, the nucleon bitfield update, the daughter's half-life,
// the decay counter, the last decay time and the chain-ring append. The
// arithmetic lives in decay_math.cuh.
//
// What bounds it on an H100: device memory. A nucleus that does not decay
// costs 20 bytes read (its half-life and its key) and one threefry hash; a
// decay adds about 40 + 16 W bytes of scattered reads and writes. So the
// design keeps everything else off device memory: the four uniforms are
// hashed in the kernel from the substep key (counters 1-3 only when the
// nucleus decays), the table rows are gathered in the kernel through the
// read-only cache (parent row, then only the chosen daughter's row), and the
// carry is updated in place, so a substep allocates and copies nothing. The
// layout is the port's nucleus-major one; the per-thread ring and word
// accesses are strided, which only decaying nuclei pay.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decay_math.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) decay_stats_kernel(PqDecayView v, int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < B) pq_decay_stats_nucleus(v, i);
}

}  // namespace

extern "C" {

// Scalars (B,) z, n, chain_cursor int32, half_life, time_passed,
// last_decay_time f32; decay_counts (B, 8) int32; alive/proton words (B, W)
// int64; chain rings (B, C) int32 x5 and f32; keys (B, 2) int64; rows
// (CELLS, 16) f32; all contiguous on the device. Updates the carry in place
// on `stream` and returns cudaGetLastError().
int pyqmd_decay_stats(void* z, void* n, void* chain_cursor, void* half_life,
                      const void* time_passed, void* last_decay_time, void* decay_counts,
                      void* alive_bits, void* proton_bits, void* chain_z0, void* chain_n0,
                      void* chain_dtype, void* chain_z1, void* chain_n1, void* chain_time,
                      const void* keys, const void* rows, int B, int W, int C,
                      float step_time, void* stream) {
  if (B == 0) return 0;
  const PqDecayView v = pq_decay_view(z, n, chain_cursor, half_life, time_passed,
                                      last_decay_time, decay_counts, alive_bits, proton_bits,
                                      chain_z0, chain_n0, chain_dtype, chain_z1, chain_n1,
                                      chain_time, keys, rows, W, C, step_time);
  const int blocks = (B + kThreads - 1) / kThreads;
  decay_stats_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(v, (int64_t)B);
  return (int)cudaGetLastError();
}

}  // extern "C"
