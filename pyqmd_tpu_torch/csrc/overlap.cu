// One Jacobi overlap projection, one thread block per nucleus.
//
// Replaces the TPU kernel pyqmd_tpu/kernels/overlap_pallas.py:_overlap_kernel
// (group 1 and packed groups alike); its contract is
// pyqmd_tpu_torch/core/overlap.py _resolve_once. Alive pairs closer than
// overlap_min_dist push apart by (md - max(dist, 0.001))/2 along the unit
// offset; coincident pairs push along +-(cos, sin)(u_i + u_j), + when
// i < j. Per particle the negated sum is capped at md/2 and applied to
// alive slots.
//
// What bounds it on an H100: the issue rate of the range test over
// P(P-1)/2 pairs per nucleus (a few flops each), against 21 bytes read and
// 8 written per slot; the few pairs in range add a sqrt and a division.
//
// The design is the force kernel's (forces.cu): each pair once, over the
// upper triangle of 32-slot tile pairs shared out among the warps, the
// partner's position by __shfl_sync and the partner's share by a second
// shuffle, per-warp buffers in shared memory summed in warp order, no
// atomics. The push is antisymmetric: the random direction with i and j
// swapped has the same cos/sin bits and the opposite sign (pq_overlap_rand_dir),
// and (dx, dy)/dist negates. The range test dist2 < md^2 comes first; a
// round in which no lane of the warp holds a pair in range skips the push
// and the second shuffle, and only a lane in range reads its partner's
// cos and sin from shared memory. Each slot sits there as one float4
// {x, y, cos u, sin u}, cos and sin computed once per slot with the
// precise cosf/sinf. The sign comes from the global slot indices, and the
// cap applies after the deterministic sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_math.cuh"
#include "pair_tiles.cuh"
#include "smem_opt_in.cuh"

namespace {

// The pushes of one tile pair (ti <= tj) for the calling warp, as
// forces.cu:tile_pair returns the forces.
__device__ void tile_pair(const float4* s, uint32_t alive_i, uint32_t alive_j, int ti, int tj,
                          float md, float md2, float* ax, float* ay, float* bx, float* by) {
  const int lane = threadIdx.x & 31;
  const float4 mine = s[ti * 32 + lane];
  const float4 part = s[tj * 32 + lane];
  const bool diag = ti == tj;
  float aix = 0.0f, aiy = 0.0f, ajx = 0.0f, ajy = 0.0f;
  for (int r = pq_first_round(diag); r < pq_end_round(diag); ++r) {
    const uint32_t pairs = pq_round_pairs(alive_i, alive_j, r, diag);
    if (pairs == 0u) continue;  // warp-uniform
    const int src = (lane + r) & 31;
    const float dx = __shfl_sync(0xffffffffu, part.x, src) - mine.x;
    const float dy = __shfl_sync(0xffffffffu, part.y, src) - mine.y;
    const float dist2 = pq_dist2(dx, dy);
    const bool hit = ((pairs >> lane) & 1u) && dist2 < md2;
    if (!__any_sync(0xffffffffu, hit)) continue;
    float px = 0.0f, py = 0.0f;
    if (hit) {
      const float4 pj = s[tj * 32 + src];
      // i < j, unless the partner wrapped to a lower lane of the same tile.
      const float sign = (diag && lane + r >= 32) ? -1.0f : 1.0f;
      float cs, ss;
      pq_overlap_rand_dir(mine.z, mine.w, pj.z, pj.w, sign, &cs, &ss);
      pq_overlap_push(dx, dy, dist2, cs, ss, md, &px, &py);
    }
    aix += px;
    aiy += py;
    const int from = (lane - r) & 31;
    ajx -= __shfl_sync(0xffffffffu, px, from);
    ajy -= __shfl_sync(0xffffffffu, py, from);
  }
  *ax = aix;
  *ay = aiy;
  *bx = ajx;
  *by = ajy;
}

__global__ void __launch_bounds__(kPqMaxWarps * 32)
overlap_step_kernel(const float2* __restrict__ pos, const uint8_t* __restrict__ alive,
                    const float* __restrict__ u, float2* __restrict__ out_pos, int P,
                    float md, float md2, float max_step) {
  const int T = (P + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  extern __shared__ float4 smem[];
  float4* s = smem;                     // T*32 slots {x, y, cos u, sin u}
  float2* buf = (float2*)(s + T * 32);  // warps x T*32 partial pushes
  __shared__ uint32_t alive_bits[kPqMaxTiles];
  const size_t base = (size_t)blockIdx.x * P;

  // A warp loads whole tiles and ballots their alive bits; padding slots
  // past P are dead.
  for (int i = threadIdx.x; i < T * 32; i += blockDim.x) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bool a = false;
    if (i < P) {
      const float2 p = pos[base + i];
      const float ui = u[base + i];
      v = make_float4(p.x, p.y, cosf(ui), sinf(ui));
      a = alive[base + i] != 0;
    }
    s[i] = v;
    for (int w = 0; w < warps; ++w) buf[(size_t)w * T * 32 + i] = make_float2(0.0f, 0.0f);
    const uint32_t bits = __ballot_sync(0xffffffffu, a);
    if (lane == 0) alive_bits[i >> 5] = bits;
  }
  __syncthreads();

  float2* mine = buf + (size_t)warp * T * 32;
  int k = 0;
  for (int ti = 0; ti < T; ++ti) {
    for (int tj = ti; tj < T; ++tj, ++k) {
      if (k % warps != warp) continue;
      if (alive_bits[ti] == 0u || alive_bits[tj] == 0u) continue;
      float ax, ay, bx, by;
      tile_pair(s, alive_bits[ti], alive_bits[tj], ti, tj, md, md2, &ax, &ay, &bx, &by);
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
  __syncthreads();

  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float4 si = s[i];
    if (!((alive_bits[i >> 5] >> (i & 31)) & 1u)) {
      out_pos[base + i] = make_float2(si.x, si.y);
      continue;
    }
    float sx = 0.0f, sy = 0.0f;
    for (int w = 0; w < warps; ++w) {
      const float2 b = buf[(size_t)w * T * 32 + i];
      sx += b.x;
      sy += b.y;
    }
    const float dx = -sx;
    const float dy = -sy;
    const float mag = sqrtf(pq_dist2(dx, dy));
    const float scale = fminf(1.0f, max_step / fmaxf(mag, 1e-9f));
    out_pos[base + i] =
        make_float2(pq_add(si.x, pq_mul(dx, scale)), pq_add(si.y, pq_mul(dy, scale)));
  }
}

}  // namespace

extern "C" {

// pos/out_pos (B, P, 2) f32, alive (B, P) one byte per slot, u (B, P) f32;
// all contiguous on the device; P <= 32 * kPqMaxTiles. Launches on
// `stream` and returns cudaGetLastError().
int pyqmd_overlap_step(const void* pos, const void* alive, const void* u, void* out_pos,
                       int B, int P, float md, float md2, float max_step, void* stream) {
  static int opted[kPqMaxDevices];
  if (B == 0 || P == 0) return 0;
  const PqTileLaunch l = pq_tile_launch(P, sizeof(float4));
  const cudaError_t err = pq_opt_in_smem(overlap_step_kernel, l.smem, opted);
  if (err != cudaSuccess) return (int)err;
  overlap_step_kernel<<<B, l.warps * 32, l.smem, (cudaStream_t)stream>>>(
      (const float2*)pos, (const uint8_t*)alive, (const float*)u, (float2*)out_pos, P, md,
      md2, max_step);
  return (int)cudaGetLastError();
}

}  // extern "C"
