"""What the force and overlap kernels' one-pass-per-pair design rests on,
checked on the CPU: ``csrc/pair_math.cuh`` and ``csrc/pair_tiles.cuh``
compiled with ``g++ -ffp-contract=off`` (the kernels spell their products
and sums so that nvcc contracts nothing either).

- The pair terms are antisymmetric bitwise: the j side of a pair is the
  exact negation of the i side, for the force (both modes) and the overlap
  push, over random pairs, coincident pairs, pairs whose dist2 sits within
  a few ULP of the 0.01 cut, and pairs at every cut of the force law and
  its float neighbours.
- The fast-math form (reciprocals folded on the host) stays within the
  kernel bar of 5e-3 of the plain force law.
- The rounds of a tile pair, and of the small-nucleus kernel's groups of
  2-32 lanes, meet every pair of alive slots exactly once, and the launch
  shape fits Hopper's shared memory at every capacity.
"""

import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch threads)
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import forces
from pyqmd_tpu_torch.kernels.forces import MAX_PARTICLES, force_params

CSRC = Path(__file__).resolve().parent.parent / "pyqmd_tpu_torch" / "csrc"

SHIM = r"""
#include "pair_math.cuh"
#include "pair_tiles.cuh"

extern "C" {
// Both sides of each pair: gi = pq_pair_term(pos_j - pos_i), gj = the
// same with i and j swapped; (x, y) interleaved.
void shim_force_sides(const float* xi, const float* yi, const float* xj, const float* yj,
                      const int* pp, const int* same, int n, const PqForceParams* c,
                      float* gi, float* gj) {
  for (int k = 0; k < n; ++k) {
    pq_pair_term(xj[k] - xi[k], yj[k] - yi[k], pp[k], same[k], *c, c->fast_math,
                 gi + 2 * k, gi + 2 * k + 1);
    pq_pair_term(xi[k] - xj[k], yi[k] - yj[k], pp[k], same[k], *c, c->fast_math,
                 gj + 2 * k, gj + 2 * k + 1);
  }
}

// Both sides of each overlap pair, i < j: the push on i and the push on j.
void shim_overlap_sides(const float* xi, const float* yi, const float* xj, const float* yj,
                        const float* ui, const float* uj, int n, float md, float* pi,
                        float* pj) {
  for (int k = 0; k < n; ++k) {
    const float cui = cosf(ui[k]), sui = sinf(ui[k]), cuj = cosf(uj[k]), suj = sinf(uj[k]);
    float cs, ss;
    const float dx = xj[k] - xi[k], dy = yj[k] - yi[k];
    pq_overlap_rand_dir(cui, sui, cuj, suj, 1.0f, &cs, &ss);
    pq_overlap_push(dx, dy, pq_dist2(dx, dy), cs, ss, md, pi + 2 * k, pi + 2 * k + 1);
    const float ex = xi[k] - xj[k], ey = yi[k] - yj[k];
    pq_overlap_rand_dir(cuj, suj, cui, sui, -1.0f, &cs, &ss);
    pq_overlap_push(ex, ey, pq_dist2(ex, ey), cs, ss, md, pj + 2 * k, pj + 2 * k + 1);
  }
}

void shim_pair_force(const float* dist2, const int* pp, const int* same, int n,
                     const PqForceParams* c, float* out) {
  for (int i = 0; i < n; ++i) {
    const float dist = sqrtf(fmaxf(dist2[i], 1e-12f));
    out[i] = pq_pair_force(dist, dist2[i], pp[i], same[i], *c, c->fast_math);
  }
}

unsigned shim_round_pairs(unsigned alive_i, unsigned alive_j, int r, int diag) {
  return pq_round_pairs(alive_i, alive_j, r, diag != 0);
}
unsigned shim_sub_round_pairs(unsigned alive, int d, int sub) {
  return pq_sub_round_pairs(alive, d, sub);
}
int shim_first_round(int diag) { return pq_first_round(diag != 0); }
int shim_end_round(int diag) { return pq_end_round(diag != 0); }
int shim_max_warps(void) { return kPqMaxWarps; }
long shim_max_smem(void) { return (long)kPqMaxSharedBytes; }
void shim_tile_launch(int P, int slot_bytes, int* warps, long* smem) {
  const PqTileLaunch l = pq_tile_launch(P, (size_t)slot_bytes);
  *warps = l.warps;
  *smem = (long)l.smem;
}

// The force kernel's launch shape and job list: counts in out[0..3]
// (warps, jobs, paired, smem), first[] and job[] as the kernel takes them.
void shim_force_launch(int P, long* out, unsigned short* first, unsigned short* job) {
  PqForceJobs j;
  const PqForceLaunch l = pq_force_launch(P, &j);
  out[0] = l.warps;
  out[1] = l.jobs;
  out[2] = l.paired;
  out[3] = (long)l.smem;
  for (int w = 0; w <= kPqMaxWarps; ++w) first[w] = j.first[w];
  for (int k = 0; k < l.jobs; ++k) job[k] = j.job[k];
}
int shim_job_cost(int code) { return pq_job_cost(code); }
int shim_max_force_jobs(void) { return kPqMaxForceJobs; }

// The pairs of slots that the force kernel's sweep meets at capacity P,
// walked job by job and row by row as forces.cu walks them, for the
// tiles' alive bits: met[i * 32T + j] counts pair (i, j), i < j.
void shim_force_pairs_met(int P, const unsigned* alive, unsigned char* met) {
  PqForceJobs j;
  const PqForceLaunch l = pq_force_launch(P, &j);
  const int n = (P + 31) / 32 * 32;
  for (int w = 0; w < l.warps; ++w) {
    for (int k = j.first[w]; k < j.first[w + 1]; ++k) {
      const int code = j.job[k], tj = pq_job_partner(code);
      const bool diag = pq_job_kind(code) == kPqJobDiag;
      for (int q = 0; q < pq_job_rows(code); ++q) {
        const int ti = pq_job_row(code) + q;
        for (int r = pq_first_round(diag); r < pq_end_round(diag); ++r) {
          const unsigned bits = pq_round_pairs(alive[ti], alive[tj], r, diag);
          for (int lane = 0; lane < 32; ++lane) {
            if (!(bits >> lane & 1u)) continue;
            const int a = ti * 32 + lane, b = tj * 32 + ((lane + r) & 31);
            ++met[(a < b ? a : b) * n + (a < b ? b : a)];
          }
        }
      }
    }
  }
}
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("pair_symmetry")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", f"-I{CSRC}",
         str(d / "shim.cpp"), "-o", str(lib), "-lm"],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib))
    lib.shim_round_pairs.restype = ctypes.c_uint
    lib.shim_sub_round_pairs.restype = ctypes.c_uint
    lib.shim_max_smem.restype = ctypes.c_long
    lib.shim_force_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _pairs(rng) -> tuple[np.ndarray, ...]:
    """(xi, yi, xj, yj) f32: random pairs near the simulation's ~400-unit
    coordinates and near 0, coincident pairs, pairs at every cut of the
    force law (0.1 = sqrt(0.01), 2.8, 4.25, 8, 9) and their f32
    neighbours, and pairs whose dist2 is within a few ULP of 0.01."""
    cuts = []
    for m in (0.1, 2.8, 4.25, 5.0, 8.0, 9.0):
        f = np.float32(m)
        cuts += [np.nextafter(np.nextafter(f, np.float32(0)), np.float32(0)),
                 np.nextafter(f, np.float32(0)), f, np.nextafter(f, np.float32(100))]
    # dx with dx*dx a few ULP either side of f32(0.01).
    near = [np.sqrt(np.float64(np.float32(0.01)) + k * 2.0 ** -30) for k in range(-6, 7)]
    d = np.concatenate([rng.uniform(0.0, 20.0, 3000), np.repeat(cuts, 20), np.repeat(near, 20),
                        np.zeros(40)]).astype(np.float32)
    n = d.size
    ang = rng.uniform(0, 2 * math.pi, n)
    # Axis-aligned offsets keep the cut distances exact; the rest are turned.
    ang[3000:] = rng.choice([0.0, 0.5 * math.pi, math.pi, 1.5 * math.pi], n - 3000)
    origin = np.where(rng.uniform(size=n) < 0.5, 400.0, 0.0) + rng.uniform(-30, 30, n)
    origin[3000:] = np.where(rng.uniform(size=n - 3000) < 0.5, 0.0, 400.0)
    xi = origin.astype(np.float32)
    yi = (origin[::-1] * 0.5).astype(np.float32)
    xj = (xi + d * np.round(np.cos(ang), 12)).astype(np.float32)
    yj = (yi + d * np.round(np.sin(ang), 12)).astype(np.float32)
    return xi, yi, xj, yj


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("pp,same", [(0, 0), (0, 1), (1, 1)])
def test_force_pair_term_is_antisymmetric(shim, fast, pp, same):
    cfg = SimConfig(fast_math=fast)
    xi, yi, xj, yj = _pairs(np.random.default_rng(10 * pp + same + 100 * fast))
    n = xi.size
    gi = np.empty(2 * n, np.float32)
    gj = np.empty(2 * n, np.float32)
    ppa = np.full(n, pp, np.int32)
    samea = np.full(n, same, np.int32)
    params = force_params(cfg)
    shim.shim_force_sides(*map(_ptr, (xi, yi, xj, yj, ppa, samea)), n, ctypes.byref(params),
                          _ptr(gi), _ptr(gj))
    np.testing.assert_array_equal(gj, -gi)
    dx, dy = xj - xi, yj - yi
    d2 = dx * dx + dy * dy
    # Coincident pairs drop out; the cut at dist2 = 0.01 is met from both sides.
    assert (gi.reshape(n, 2)[d2 < 0.01] == 0).all()
    assert ((d2 >= 0.01) & (d2 < np.float32(0.01) * (1 + 1e-6))).any()
    assert ((d2 < 0.01) & (d2 > np.float32(0.01) * (1 - 1e-6))).any()
    assert np.count_nonzero(gi) > n
    if not fast:
        # The i side is the plain version's one-pair force, term for term.
        pos = torch.from_numpy(np.stack([np.stack([xi, yi], -1), np.stack([xj, yj], -1)], 1))
        ptype = torch.full((n, 2), 0 if pp else 1, dtype=torch.int32)
        if not same:
            ptype[:, 1] = 1 - ptype[:, 0]
        alive = torch.ones(n, 2, dtype=torch.bool)
        ref = forces.pair_forces_block(pos, ptype, alive, pos, ptype, alive, cfg)[:, 0].numpy()
        np.testing.assert_allclose(gi.reshape(n, 2), ref, rtol=1e-5, atol=1e-6)


def test_overlap_push_is_antisymmetric(shim):
    md = SimConfig().overlap_min_dist
    rng = np.random.default_rng(5)
    xi, yi, xj, yj = _pairs(rng)
    n = xi.size
    ui, uj = rng.uniform(0, 2 * math.pi, (2, n)).astype(np.float32)
    pi = np.empty(2 * n, np.float32)
    pj = np.empty(2 * n, np.float32)
    shim.shim_overlap_sides(*map(_ptr, (xi, yi, xj, yj, ui, uj)), n, ctypes.c_float(md),
                            _ptr(pi), _ptr(pj))
    np.testing.assert_array_equal(pj, -pi)
    coincident = (xi == xj) & (yi == yj)
    assert coincident.sum() >= 40
    # Coincident pairs push along the random direction, one unit of md/2.
    push = pi.reshape(n, 2)[coincident]
    np.testing.assert_allclose(np.hypot(push[:, 0], push[:, 1]), (md - 0.001) / 2, rtol=1e-6)


@pytest.mark.parametrize("pp,same", [(0, 0), (0, 1), (1, 1)])
def test_fast_math_reciprocals_hold_the_kernel_bar(shim, pp, same):
    fast = SimConfig(fast_math=True)
    exact = SimConfig(fast_math=False)
    rng = np.random.default_rng(40 + 2 * pp + same)
    dist = np.concatenate([rng.uniform(0.1, 1.0, 2000), rng.uniform(0.1, 20.0, 8000)])
    dist2 = (dist * dist).astype(np.float32)
    n = dist2.size
    out = np.empty(n, np.float32)
    params = force_params(fast)
    assert params.inv_strong_range == pytest.approx(1 / exact.strong_range, rel=1e-7)
    shim.shim_pair_force(_ptr(dist2), _ptr(np.full(n, pp, np.int32)),
                         _ptr(np.full(n, same, np.int32)), n, ctypes.byref(params), _ptr(out))
    d2 = torch.from_numpy(dist2)
    ref = forces.pair_net_force(forces.sqrt_rn(d2), d2, torch.full((n,), bool(pp)),
                                torch.full((n,), bool(same)), exact).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-3)
    assert not np.array_equal(out, ref)  # the reciprocal form is in use


@pytest.mark.parametrize("diag", [True, False])
def test_rounds_meet_every_alive_pair_once(shim, diag):
    rng = np.random.default_rng(int(diag))
    masks = [0xFFFFFFFF, 0, 0xFF, 0x1, 0x80000000, 0xFFFF0000, 0xAAAAAAAA]
    masks += [int(m) for m in rng.integers(0, 2**32, 40, dtype=np.uint64)]
    first, end = shim.shim_first_round(int(diag)), shim.shim_end_round(int(diag))
    for k, mi in enumerate(masks):
        mj = mi if diag else masks[(k * 7 + 3) % len(masks)]
        met = {}
        for r in range(first, end):
            bits = shim.shim_round_pairs(mi, mj, r, int(diag))
            for lane in range(32):
                if bits >> lane & 1:
                    j = (lane + r) & 31
                    key = tuple(sorted((lane, j))) if diag else (lane, j)
                    met[key] = met.get(key, 0) + 1
        alive_i = [l for l in range(32) if mi >> l & 1]
        alive_j = [l for l in range(32) if mj >> l & 1]
        if diag:
            want = {(a, b) for a in alive_i for b in alive_i if a < b}
        else:
            want = {(a, b) for a in alive_i for b in alive_j}
        assert set(met) == want, hex(mi)
        assert all(c == 1 for c in met.values()), hex(mi)


@pytest.mark.parametrize("sub", [2, 4, 8, 16, 32])
def test_sub_warp_rounds_meet_every_alive_pair_once(shim, sub):
    """Rounds d = 1 .. sub/2 of the small-nucleus kernel: lane l = g0 + s
    meets lane g0 + ((s + d) & (sub - 1)) of its own group, and over the
    rounds every pair of alive lanes inside a group is met once."""
    rng = np.random.default_rng(sub)
    masks = [0xFFFFFFFF, 0, 0x1, 0x80000001, 0x0F0F0F0F, 0xAAAAAAAA]
    masks += [int(m) for m in rng.integers(0, 2**32, 60, dtype=np.uint64)]
    for mask in masks:
        met = {}
        for d in range(1, sub // 2 + 1):
            bits = shim.shim_sub_round_pairs(mask, d, sub)
            for lane in range(32):
                if bits >> lane & 1:
                    g0 = lane - lane % sub
                    key = tuple(sorted((lane, g0 + (lane - g0 + d) % sub)))
                    met[key] = met.get(key, 0) + 1
        alive = [l for l in range(32) if mask >> l & 1]
        want = {(a, b) for a in alive for b in alive if a < b and a // sub == b // sub}
        assert set(met) == want, hex(mask)
        assert all(c == 1 for c in met.values()), hex(mask)


def test_tile_launch_fits_shared_memory(shim):
    max_warps, max_smem = shim.shim_max_warps(), shim.shim_max_smem()
    assert max_smem <= 232448
    for p in (1, 8, 32, 33, 100, 256, 1024, MAX_PARTICLES, 2048):
        t = -(-p // 32)
        warps, smem = ctypes.c_int(), ctypes.c_long()
        shim.shim_tile_launch(p, 16, ctypes.byref(warps), ctypes.byref(smem))
        assert 1 <= warps.value <= min(max_warps, t * (t + 1) // 2), p
        assert smem.value == t * 32 * (16 + 8 * warps.value) <= max_smem, p
    shim.shim_tile_launch(256, 16, ctypes.byref(warps), ctypes.byref(smem))
    assert (warps.value, smem.value) == (8, 20480)


def _force_schedule(shim, p):
    """(warps, jobs, paired, smem), then each warp's job codes."""
    out = np.zeros(4, np.int64)
    first = np.zeros(shim.shim_max_warps() + 1, np.uint16)
    job = np.zeros(shim.shim_max_force_jobs(), np.uint16)
    shim.shim_force_launch(p, _ptr(out), _ptr(first), _ptr(job))
    warps = int(out[0])
    return tuple(int(v) for v in out), [job[first[w]:first[w + 1]].tolist() for w in range(warps)]


@pytest.mark.parametrize("t", range(2, 65))
def test_force_job_list_meets_every_alive_pair_once(shim, t):
    """The force kernel's job list at T tiles, for the warps its launch
    takes: every tile pair (ti <= tj) in exactly one job, two-row jobs from
    T = 3 on, no warp's cost above the mean plus one job, and its rounds,
    walked as the kernel walks them, meet every pair of alive slots once:
    all slots alive, a ragged last tile, random alive slots beside whole
    dead tiles."""
    (warps, jobs, paired, smem), per_warp = _force_schedule(shim, 32 * t)
    assert warps == min(shim.shim_max_warps(), jobs) and smem <= shim.shim_max_smem()
    assert jobs == t + t * t // 4 and sum(map(len, per_warp)) == jobs
    assert (paired > 0) == (t >= 3)
    met = {}
    for code in (c for codes in per_warp for c in codes):
        kind, ta, tj = code >> 12, (code >> 6) & 63, code & 63
        rows = [tj] if kind == 2 else [ta, ta + 1] if kind == 0 else [ta]
        assert kind in (0, 1, 2) and (kind == 2 or all(r < tj for r in rows))
        for r in rows:
            met[r, tj] = met.get((r, tj), 0) + 1
    assert met == {(a, b): 1 for b in range(t) for a in range(b + 1)}
    assert sum(1 for codes in per_warp for c in codes if c >> 12 == 0) == paired
    costs = [sum(shim.shim_job_cost(c) for c in codes) for codes in per_warp]
    biggest = max(shim.shim_job_cost(c) for codes in per_warp for c in codes)
    assert max(costs) <= sum(costs) / warps + biggest, costs

    rng = np.random.default_rng(t)
    n = 32 * t
    ragged = np.arange(n) < n - 18
    scattered = rng.uniform(size=n) < 0.8
    scattered.reshape(t, 32)[rng.choice(t, max(1, t // 4), replace=False)] = False
    for alive in (np.ones(n, bool), ragged, scattered):
        p = n - 18 if alive is ragged else n
        bits = np.packbits(alive.reshape(t, 32), axis=1, bitorder="little").view(np.uint32)
        counts = np.zeros((n, n), np.uint8)
        shim.shim_force_pairs_met(p, _ptr(np.ascontiguousarray(bits[:, 0])), _ptr(counts))
        np.testing.assert_array_equal(counts, np.triu(np.outer(alive, alive), 1))
