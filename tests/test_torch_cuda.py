"""CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; each test skips where no CUDA device is present. The
machine with the card has no JAX, so run them without the suite's
conftest (which imports JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import ctypes
import dataclasses
import subprocess

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch threads)
from pyqmd_tpu_torch import prng
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import decay, forces, overlap
from pyqmd_tpu_torch.core.dynamics import FrameDynamics
from pyqmd_tpu_torch.core.init import ensemble_init
from pyqmd_tpu_torch.kernels import _build
from pyqmd_tpu_torch.kernels.decay import DECAY_FIELDS, decay_stats_frame, decay_stats_substep
from pyqmd_tpu_torch.kernels.forces import force_step
from pyqmd_tpu_torch.kernels.overlap import overlap_step

pytestmark = pytest.mark.cuda

DT = 1 / 240.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _batch(dev, b, p, spread, seed):
    g = torch.Generator().manual_seed(seed)
    pos = 400 - spread / 2 + spread * torch.rand(b, p, 2, generator=g)
    vel = 2 * torch.randn(b, p, 2, generator=g)
    ptype = torch.randint(0, 2, (b, p), generator=g, dtype=torch.int32)
    alive = torch.rand(b, p, generator=g) < 0.9
    u = 6.28 * torch.rand(b, p, generator=g)
    return [t.to(dev) for t in (pos, vel, ptype, alive, u)]


@pytest.mark.parametrize("p,b", [(256, 16), (100, 9), (8, 70), (33, 21), (2000, 2)])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_force_kernel_matches_plain(dev, p, b, integrator):
    base = SimConfig.for_isotope(2, 2, pad_to=p, integrator=integrator)
    pos, vel, ptype, alive, _ = _batch(dev, b, p, 40.0 if p > 8 else 12.0, seed=p + b)
    exact = dataclasses.replace(base, fast_math=False)
    ref = forces.force_step(pos, vel, ptype, alive, DT, exact)
    before = force_step.launches
    got = force_step(pos, vel, ptype, alive, DT, exact)
    fast = force_step(pos, vel, ptype, alive, DT, base)
    assert force_step.launches == before + 2
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
    for g, r in zip(fast, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=5e-3)


@pytest.mark.parametrize("p,b", [(2, 301), (5, 77), (8, 70), (16, 33), (20, 45), (32, 19)])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_small_force_kernel_matches_plain(dev, p, b, integrator):
    """P <= 32 takes the sub-warp kernel (B * next_pow2(P) not a multiple
    of 32 for most cases; member 1 with no alive slot)."""
    base = SimConfig.for_isotope(2, 2, pad_to=p, integrator=integrator)
    pos, vel, ptype, alive, _ = _batch(dev, b, p, 12.0 if p <= 8 else 25.0, seed=p + b)
    alive[1] = False
    exact = dataclasses.replace(base, fast_math=False)
    ref = forces.force_step(pos, vel, ptype, alive, DT, exact)
    before, small_before = force_step.launches, force_step.small_launches
    got = force_step(pos, vel, ptype, alive, DT, exact)
    fast = force_step(pos, vel, ptype, alive, DT, dataclasses.replace(base, fast_math=True))
    assert force_step.launches == before + 2 and force_step.small_launches == small_before + 2
    for g, f, r in zip(got, fast, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(f, r, rtol=0, atol=5e-3)
    assert torch.equal(got[0][~alive], pos[~alive]) and torch.equal(got[1][~alive], vel[~alive])
    again = force_step(pos, vel, ptype, alive, DT, exact)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def test_force_kernel_route_is_set_by_capacity_alone(dev):
    for p, small in ((32, 1), (33, 0)):
        pos, vel, ptype, alive, _ = _batch(dev, 4, p, 20.0, seed=p)
        before, small_before = force_step.launches, force_step.small_launches
        force_step(pos, vel, ptype, alive, DT, SimConfig.for_isotope(2, 2, pad_to=p))
        assert force_step.launches == before + 1
        assert force_step.small_launches == small_before + small


@pytest.mark.parametrize("p,b", [(256, 16), (100, 9), (8, 70), (33, 21), (2000, 2)])
def test_overlap_kernel_matches_plain(dev, p, b):
    cfg = SimConfig.for_isotope(2, 2, pad_to=p)
    pos, _, _, alive, u = _batch(dev, b, p, 10.0 if p > 8 else 4.0, seed=3 * p + b)
    pos[:, :3] = 400.0  # coincident nucleons
    alive[:, :3] = True
    before = overlap_step.launches
    got = overlap_step(pos, alive, u, cfg)
    assert overlap_step.launches == before + 1
    torch.testing.assert_close(got, overlap.resolve_overlaps(pos, alive, u, cfg),
                               rtol=1e-4, atol=1e-4)


def _edge_batch(dev, case):
    """A batch of 4 at P=100 (spread 30) with a shape the tile schedule
    must handle: members with one alive slot and with none, a 32-slot tile
    with no alive slot, or a dense cluster with a coincident triple."""
    pos, vel, ptype, alive, u = _batch(dev, 4, 100, 30.0, seed=len(case))
    if case == "one_and_none":
        alive[:] = False
        alive[0, 37] = alive[1, 99] = True  # members 2-3 have none
    elif case == "dead_tile":
        alive[:, 32:64] = False
    elif case == "dense":
        pos = 400 + (pos - 400) * (4.0 / 30.0)
        pos[:, :3] = 400.0
        alive[:, :3] = True
    return pos, vel, ptype, alive, u


@pytest.mark.parametrize("case", ["one_and_none", "dead_tile", "dense"])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_kernels_take_edge_nuclei(dev, case, integrator):
    pos, vel, ptype, alive, u = _edge_batch(dev, case)
    exact = SimConfig.for_isotope(26, 30, pad_to=100, integrator=integrator, fast_math=False)
    tol = 2e-4 if case == "dense" else 1e-4
    ref = forces.force_step(pos, vel, ptype, alive, DT, exact)
    got = force_step(pos, vel, ptype, alive, DT, exact)
    fast = force_step(pos, vel, ptype, alive, DT, dataclasses.replace(exact, fast_math=True))
    for g, f, r in zip(got, fast, ref):
        torch.testing.assert_close(g, r, rtol=tol, atol=tol)
        torch.testing.assert_close(f, r, rtol=0, atol=5e-3)
    assert torch.equal(got[0][~alive], pos[~alive]) and torch.equal(got[1][~alive], vel[~alive])
    got = overlap_step(pos, alive, u, exact)
    torch.testing.assert_close(got, overlap.resolve_overlaps(pos, alive, u, exact),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got[~alive], pos[~alive])


@pytest.mark.parametrize("fast_math", [False, True])
def test_kernels_give_the_same_bits_on_every_launch(dev, fast_math):
    cfg = SimConfig.for_isotope(92, 146, pad_to=128, fast_math=fast_math)
    pos, vel, ptype, alive, u = _batch(dev, 64, 256, 40.0, seed=11)
    first = force_step(pos, vel, ptype, alive, DT, cfg)
    for _ in range(3):
        again = force_step(pos, vel, ptype, alive, DT, cfg)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    first = overlap_step(pos, alive, u, cfg)
    for _ in range(3):
        assert torch.equal(overlap_step(pos, alive, u, cfg), first)


SQRT_CHECK = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "pair_math.cuh"
__global__ void check(uint32_t lo, uint32_t n, unsigned long long* bad) {
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(lo + i);
    if (__float_as_uint(pq_sqrt_rn(x)) != __float_as_uint(sqrtf(x))) atomicAdd(bad, 1ull);
  }
}
extern "C" int sqrt_mismatches(uint32_t lo, uint32_t hi, unsigned long long* out) {
  unsigned long long* bad;
  cudaMalloc(&bad, sizeof(*bad));
  cudaMemset(bad, 0, sizeof(*bad));
  check<<<1056, 256>>>(lo, hi - lo, bad);
  cudaMemcpy(out, bad, sizeof(*bad), cudaMemcpyDeviceToHost);
  cudaFree(bad);
  return (int)cudaGetLastError();
}
"""


def test_pair_sqrt_is_correctly_rounded(dev, tmp_path):
    """``pq_sqrt_rn`` equals ``sqrtf`` bitwise on every float in
    [0.01, 2^24], the range of a pair's dist2 and far beyond it."""
    (tmp_path / "check.cu").write_text(SQRT_CHECK)
    lib = tmp_path / "libcheck.so"
    subprocess.run([_build._find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", f"-I{_build.CSRC}", "-o", str(lib),
                    str(tmp_path / "check.cu")], check=True, capture_output=True)
    lo = int(np.float32(0.01).view(np.uint32))
    hi = int(np.float32(2.0**24).view(np.uint32))
    bad = ctypes.c_ulonglong(1)
    err = ctypes.CDLL(str(lib)).sqrt_mismatches(ctypes.c_uint32(lo), ctypes.c_uint32(hi),
                                                ctypes.byref(bad))
    assert err == 0 and bad.value == 0


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    pos, vel, ptype, alive, u = _batch(dev, 4, 8, 12.0, seed=0)
    with pytest.raises(TypeError):
        force_step(pos, vel, ptype.long(), alive, DT, cfg)
    with pytest.raises(ValueError):
        force_step(pos.transpose(0, 1).contiguous().transpose(0, 1), vel, ptype, alive, DT, cfg)
    with pytest.raises(ValueError):
        force_step(pos, vel.cpu(), ptype, alive, DT, cfg)
    with pytest.raises(TypeError):
        overlap_step(pos, alive, u.double(), cfg)
    with pytest.raises(ValueError):
        overlap_step(pos, alive[:, :4], u, cfg)


def _decay_carry(dev, zn, pad_to, b, step_time, seed):
    """A state on the card with half-lives around ``step_time``, its
    bitfields, substep keys and dynamics."""
    cfg = SimConfig.for_isotope(*zn, pad_to=pad_to, max_chain_log=8)
    st = ensemble_init(cfg, b, seed=seed, device=dev)
    g = np.random.default_rng(seed)
    hl = torch.from_numpy((step_time * 10.0 ** g.uniform(-2, 2, b)).astype(np.float32))
    st = st.replace(half_life=hl.to(dev), time_passed=torch.full((b,), 3e9, device=dev))
    keys = torch.from_numpy(g.integers(0, 2**32, (b, 2), dtype=np.int64)).to(dev)
    dyn = FrameDynamics(np.float32(1.0), np.float32(1.0), np.float32(cfg.effective_dt()),
                        np.float32(step_time), None)
    return cfg, st, decay.pack_nucleon_bits(st.alive, st.ptype), keys, dyn


@pytest.mark.parametrize("zn,pad_to,b", [((6, 8), 8, 4099), ((82, 132), 8, 300),
                                         ((92, 146), 128, 64)])
def test_decay_kernel_matches_plain(dev, zn, pad_to, b):
    cfg, st, bits, keys, dyn = _decay_carry(dev, zn, pad_to, b, 1e9, seed=b)
    want, _, want_bits = decay.maybe_decay(st, cfg, keys, dyn, stats_only=True,
                                           packed_nucleons=bits)
    got = st.replace(**{f: getattr(st, f).clone() for f in DECAY_FIELDS})
    got_bits = tuple(x.clone() for x in bits)
    before = decay_stats_substep.launches
    decay_stats_substep(got, got_bits, cfg, keys, dyn)
    assert decay_stats_substep.launches == before + 1
    for f in DECAY_FIELDS:
        if getattr(want, f).dtype == torch.float32:
            torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=1e-6, atol=0,
                                       msg=f)
        else:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert all(torch.equal(a, w) for a, w in zip(got_bits, want_bits))
    assert int((got.chain_cursor != st.chain_cursor).sum()) > b // 10


def test_decay_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cfg, st, bits, keys, dyn = _decay_carry(dev, (6, 8), 8, 64, 1e9, seed=0)
    with pytest.raises(TypeError):
        decay_stats_substep(st, bits, cfg, keys.int(), dyn)
    with pytest.raises(ValueError):
        decay_stats_substep(st, bits, cfg, keys.cpu(), dyn)
    with pytest.raises(ValueError):
        decay_stats_substep(st, (bits[0], bits[1][:8]), cfg, keys, dyn)
    with pytest.raises(TypeError):
        decay_stats_substep(st.replace(half_life=st.half_life.double()), bits, cfg, keys, dyn)
    with pytest.raises(ValueError):
        decay_stats_substep(st, bits, cfg, keys.t().contiguous().t(), dyn)


def _plain_frame(st, bits, rng, cfg, dyn, num_steps):
    """The statistics frame's plain version on the card: the key tree, then
    maybe_decay per substep; returns the carry, bitfields and next rng."""
    k3 = prng.split(rng, 3)
    for keys in prng.split(k3[:, 0], num_steps).transpose(0, 1):
        st, _, bits = decay.maybe_decay(st, cfg, keys.contiguous(), dyn, stats_only=True,
                                        packed_nucleons=bits)
    return st, bits, k3[:, 2]


@pytest.mark.parametrize("zn,pad_to,b", [((6, 8), 8, 4099), ((82, 132), 8, 300),
                                         ((92, 146), 8, 200)])
def test_decay_frame_kernel_matches_plain(dev, zn, pad_to, b):
    cfg, st, bits, rng, dyn = _decay_carry(dev, zn, pad_to, b, 1e9, seed=b)
    want, want_bits, want_rng = _plain_frame(st, bits, rng, cfg, dyn, 10)
    runs = []
    for _ in range(2):
        got = st.replace(**{f: getattr(st, f).clone() for f in DECAY_FIELDS})
        got_bits = tuple(x.clone() for x in bits)
        before = decay_stats_frame.launches
        next_rng = decay_stats_frame(got, got_bits, rng, cfg, dyn, 10)
        assert decay_stats_frame.launches == before + 1
        runs.append((got, got_bits, next_rng))
    got, got_bits, next_rng = runs[0]
    assert torch.equal(next_rng, want_rng)
    for f in DECAY_FIELDS:
        if getattr(want, f).dtype == torch.float32:
            torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=1e-6, atol=0,
                                       msg=f)
        else:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(getattr(runs[1][0], f), getattr(got, f)), f
    assert all(torch.equal(a, w) for a, w in zip(got_bits, want_bits))
    assert all(torch.equal(a, w) for a, w in zip(runs[1][1], got_bits))
    assert torch.equal(runs[1][2], next_rng)
    assert int((got.chain_cursor != st.chain_cursor).sum()) > b // 10


def test_decay_frame_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cfg, st, bits, rng, dyn = _decay_carry(dev, (6, 8), 8, 64, 1e9, seed=0)
    with pytest.raises(TypeError):
        decay_stats_frame(st, bits, rng.int(), cfg, dyn, 10)
    with pytest.raises(ValueError):
        decay_stats_frame(st, bits, rng.cpu(), cfg, dyn, 10)
    with pytest.raises(ValueError):
        decay_stats_frame(st, bits, rng.t().contiguous().t(), cfg, dyn, 10)
    with pytest.raises(ValueError):
        decay_stats_frame(st, (bits[0], bits[1][:8]), rng, cfg, dyn, 10)
    with pytest.raises(ValueError):
        decay_stats_frame(st, bits, rng, cfg, dyn, -1)
