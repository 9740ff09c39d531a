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
from pyqmd_tpu_torch import Simulation, cli, load_checkpoint, prng
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import decay, forces, overlap
from pyqmd_tpu_torch.core.dynamics import FrameDynamics
from pyqmd_tpu_torch.core.init import ensemble_init
from pyqmd_tpu_torch.kernels import _build
from pyqmd_tpu_torch.kernels.decay import DECAY_FIELDS, decay_stats_frame, decay_stats_substep
from pyqmd_tpu_torch.kernels.forces import force_step
from pyqmd_tpu_torch.kernels.overlap import overlap_step
from pyqmd_tpu_torch.kernels.substep import SUBSTEP_FIELDS, ejecta_decay_substep
from pyqmd_tpu_torch.render import render_to_host
from pyqmd_tpu_torch.state import state_to_numpy
from pyqmd_tpu_torch.utils import profiling

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


# P=600: 48,640 bytes of dynamic shared memory, under 48 KB only without the
# kernel's static arrays.
@pytest.mark.parametrize("p,b", [(256, 16), (100, 9), (8, 70), (33, 21), (600, 3), (2000, 2)])
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


@pytest.mark.parametrize("p,b", [(256, 16), (100, 9), (8, 70), (33, 21), (600, 3), (2000, 2)])
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


# --- the full-physics substep kernel (csrc/substep.cu) -----------------------

# The integer fields of a full-physics state, and the floats that only the
# decay engine and the clock write (the benchmark's ``correct`` holds both
# exactly against the plain frame on the card).
SUBSTEP_INTS = ("alive", "ptype", "z", "n", "decay_counts", "chain_z0", "chain_n0",
                "chain_dtype", "chain_z1", "chain_n1", "chain_cursor", "ej_type", "ej_alive",
                "ej_cursor", "rng")
SUBSTEP_CLOCK = ("half_life", "time_passed", "last_decay_time", "chain_time", "ej_age",
                 "ej_life")


def _substep_state(dev, species, p, e, c, ts, seed, short=2 / 3):
    """A mixed batch on ``dev`` whose ejecta rings are in use (live and dead
    slots, ages about to pass their lifetimes), random velocities, and a
    share ``short`` of the members with half-lives of a thousandth of a
    substep (they decay for certain); the config, state and frame scalars."""
    from pyqmd_tpu_torch.core.dynamics import frame_dynamics, frame_scalars
    from pyqmd_tpu_torch.core.init import mixed_ensemble_init

    z, n, _ = species[0]
    cfg = SimConfig(z=z, n=n, max_particles=p, max_ejecta=e, max_chain_log=c)
    st = mixed_ensemble_init(cfg, species, seed=seed, device="cpu")
    sc = frame_scalars(frame_dynamics(cfg, ts, 1 / 60, 20, None, cfg.physics_dt), cfg, dev)
    g = np.random.default_rng(seed)
    b = st.batch
    types = torch.from_numpy(g.integers(0, 6, (b, e)).astype(np.int32))
    life = torch.from_numpy(g.uniform(0.1, 3.0, (b, e)).astype(np.float32))
    life[types < 2] = float("inf")
    age = life * torch.from_numpy(g.uniform(0.5, 1.05, (b, e)).astype(np.float32))
    hl = st.half_life.clone()
    hl[torch.from_numpy(g.uniform(size=b) < short)] = float(sc.step_time) * 1e-3
    st = st.replace(
        vel=torch.from_numpy(g.normal(0, 2, (b, p, 2)).astype(np.float32)),
        ej_pos=torch.from_numpy(g.normal(400, 30, (b, e, 2)).astype(np.float32)),
        ej_vel=torch.from_numpy(g.normal(0, 20, (b, e, 2)).astype(np.float32)),
        ej_type=types, ej_age=torch.where(types < 2, 0.0, age), ej_life=life,
        ej_alive=torch.from_numpy(g.uniform(size=(b, e)) < 0.7),
        ej_cursor=torch.from_numpy(g.integers(0, 5 * e, b).astype(np.int32)),
        half_life=hl, time_passed=torch.full((b,), 3e9),
        chain_cursor=torch.from_numpy(g.integers(0, 3 * c, b).astype(np.int32)),
    )
    return cfg, st.to(dev), sc


@pytest.mark.parametrize("case", ["u238", "mixed_slow", "p8"])
def test_substep_kernel_matches_plain_on_the_card(dev, case):
    """The frame's first two substeps, in place on a copy of the state,
    against ``advance_ejecta`` + ``maybe_decay`` on the card from the same
    state and key: integers, rng, the decay engine's and clock's floats and
    every velocity bitwise; fragment positions (a centre of mass summed in
    another order) within 1e-4; one launch a call."""
    species, p, e, c, ts = {
        "u238": ([(92, 146, 1024)], 256, 64, 64, 3.15576e16),
        "mixed_slow": ([(92, 146, 200), (6, 8, 200), (47, 56, 200), (43, 56, 101)], 256, 40,
                       5, 0.5),
        "p8": ([(1, 2, 100), (2, 6, 100), (4, 3, 99)], 8, 20, 4, 3.15576e16),
    }[case]
    cfg, st, sc = _substep_state(dev, species, p, e, c, ts, seed=len(case))
    k3 = prng.split(st.rng, 3)
    want = st
    got = st.replace(**{f: getattr(st, f).clone() for f in SUBSTEP_FIELDS})
    for s in range(2):
        keys = prng.split(k3[:, 0], 20)[:, s]
        want = decay.maybe_decay(decay.advance_ejecta(want, cfg, sc), cfg, keys, sc)[0]
        before = ejecta_decay_substep.launches
        assert ejecta_decay_substep(got, cfg, sc, k3, s) is got
        assert ejecta_decay_substep.launches == before + 1
        for f in SUBSTEP_INTS + SUBSTEP_CLOCK + ("pos", "vel", "ej_vel"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (s, f)
        torch.testing.assert_close(got.ej_pos, want.ej_pos, rtol=1e-4, atol=1e-4)
    fired = int((want.chain_cursor != st.chain_cursor).sum())
    assert fired > st.batch // 2
    assert not torch.equal(st.ej_alive, want.ej_alive)


def test_substep_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cfg, st, sc = _substep_state(dev, [(6, 8, 64)], 16, 8, 4, 3.15576e16, seed=0)
    k3 = prng.split(st.rng, 3)
    with pytest.raises(TypeError):
        ejecta_decay_substep(st, cfg, sc, k3.int(), 0)
    with pytest.raises(ValueError):
        ejecta_decay_substep(st, cfg, sc, k3[:, :2], 0)
    with pytest.raises(ValueError):
        ejecta_decay_substep(st.replace(ej_pos=st.ej_pos.transpose(0, 1).contiguous()
                                        .transpose(0, 1)), cfg, sc, k3, 0)
    with pytest.raises(TypeError):
        ejecta_decay_substep(st.replace(half_life=st.half_life.double()), cfg, sc, k3, 0)
    with pytest.raises(ValueError):
        ejecta_decay_substep(st.replace(half_life=st.half_life.cpu()), cfg, sc, k3, 0)


@pytest.mark.parametrize("b", [1024, 1])
def test_substep_kernel_frames_on_the_card_equal_the_cpu(dev, b):
    """U-238 frames through ``make_frame_fn`` on the card (the substep
    kernel in the graph's frame) against the plain frame on the CPU from
    the same state, a third of the members decaying in the first substep:
    integers and rng exact, the decay engine's floats within 1e-6, positions
    and velocities within the benchmark's limits (ensemble 0.5 / 1.5, one
    nucleus 0.02 / 0.005); 20 substep launches a frame."""
    from pyqmd_tpu_torch.core import step

    step.make_frame_fn.cache_clear()
    cfg, st, _ = _substep_state(dev, [(92, 146, b)], 128 * 2, 64, 64 if b > 1 else 256,
                                3.15576e16, seed=b, short=1 / 3 if b > 1 else 1.0)
    cfg = SimConfig.for_isotope(92, 146, pad_to=128, max_chain_log=cfg.max_chain_log)
    fn = step.make_frame_fn(cfg, 20, b > 1)
    bare = step.ensemble_step if b > 1 else step.simulate_frame
    frames = 1 if b > 1 else 3
    got, want = st, st.to("cpu")
    for _ in range(frames):
        before = ejecta_decay_substep.launches
        got, _ = fn(got, 3.15576e16, 1 / 60)
        assert ejecta_decay_substep.launches == before + 20
        want, _ = bare(want, cfg, 3.15576e16, 1 / 60, 20, cfg.effective_dt(), cfg.physics_dt)
    a, c = state_to_numpy(want), state_to_numpy(got)
    for f in SUBSTEP_INTS:
        np.testing.assert_array_equal(c[f], a[f], err_msg=f)
    for f in SUBSTEP_CLOCK:
        np.testing.assert_allclose(c[f], a[f], rtol=1e-6, atol=0, err_msg=f)
    pos_lim, vel_lim = (0.5, 1.5) if b > 1 else (0.02, 0.005)
    for f, lim in (("pos", pos_lim), ("vel", vel_lim)):
        live = a["alive"][..., None]
        assert np.abs(np.where(live, c[f] - a[f], 0)).max() <= lim, f
    for f, lim in (("ej_pos", pos_lim), ("ej_vel", vel_lim)):
        live = a["ej_alive"][..., None]
        assert np.abs(np.where(live, c[f] - a[f], 0)).max() <= lim, f
    assert int((a["chain_cursor"] != state_to_numpy(st)["chain_cursor"]).sum()) >= max(1, b // 4)


# --- the host loop, checkpoints, the command line and the rasterizer ----------


def test_fence_waits_for_an_event_on_the_card(dev):
    x = torch.ones(1 << 20, device=dev)
    torch.cuda._sleep(50_000_000)
    y = x * 2
    event = torch.cuda.Event()
    event.record()
    profiling.fence(event)
    assert event.query()
    profiling.fence({"y": y, "n": 3})
    timer = profiling.StepTimer()
    timer.start()
    assert timer.lap(y, steps=2) > 0


def test_frames_in_flight_on_the_card(dev):
    sim = Simulation(z=6, n=8, pad_to=8, ensemble=64, device=dev)
    sim.set_preset("billion")
    small = force_step.small_launches
    for _ in range(8):
        sim.frame()
    assert force_step.small_launches - small == 8 * 20
    assert len(sim._inflight) == 3 and all(f.event is not None for f in sim._inflight)
    assert sim._nan_slots.is_pinned() and sim.fps > 0
    status = sim.status()
    assert status["alive"] == int(sim.state.alive.sum())
    assert status["decay_counts"] == sim.state.decay_counts.sum(0).tolist()


def test_nan_guard_on_the_card(dev, caplog):
    sim = Simulation(z=2, n=2, pad_to=8, device=dev)
    sim.nan_check_interval = 2
    pos = sim.state.pos.clone()
    pos[0, 0, 0] = float("nan")
    sim.state = sim.state.replace(pos=pos)
    with caplog.at_level("ERROR", logger="pyqmd_tpu_torch"):
        sim.frame()
        sim.frame()
    assert "non-finite state detected" in caplog.text


@pytest.mark.parametrize("zn,pad_to,ensemble", [((6, 8), 8, None), ((92, 146), 128, None),
                                                ((6, 8), 8, 32)])
def test_simulation_on_the_card_equals_the_cpu(dev, zn, pad_to, ensemble):
    """Same seed through ``Simulation`` on both devices: frames, a fused
    run and (single) a forced decay; integer fields, rng, status and the
    decay log equal, pos/vel within 1e-3 on the first frame."""
    sims = [Simulation(z=zn[0], n=zn[1], seed=4, pad_to=pad_to, ensemble=ensemble, device=d)
            for d in ("cpu", dev)]
    for s in sims:
        s.set_time_scale(3.15576e18 if zn[0] > 6 else 3.15576e12)
        s.frame()
    a, c = (state_to_numpy(s.state) for s in sims)
    np.testing.assert_allclose(c["pos"], a["pos"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(c["vel"], a["vel"], rtol=1e-3, atol=1e-3)
    for s in sims:
        s.frame()
        s.run(3, fused=True)
        if not ensemble:
            s.force_decay()
    a, c = (state_to_numpy(s.state) for s in sims)
    for f in ("z", "n", "decay_counts", "chain_z0", "chain_n0", "chain_dtype", "chain_z1",
              "chain_n1", "chain_cursor", "rng", "alive", "ptype", "ej_type", "ej_alive",
              "ej_cursor"):
        np.testing.assert_array_equal(c[f], a[f], err_msg=f)
    sa, sc = (s.status() for s in sims)
    for k in ("isotope", "alive", "decay_counts", "substeps"):
        assert sc[k] == sa[k], k
    if not ensemble:
        assert sims[1].decay_log == sims[0].decay_log and sims[1].decay_log
        assert sc["backend"] == "cuda" and sa["backend"] == "cpu"


def test_checkpoint_crosses_devices(dev, tmp_path):
    sim = Simulation(z=6, n=8, seed=1, pad_to=8, ensemble=16, device=dev)
    sim.frame()
    path = str(tmp_path / "ck.npz")
    sim.save(path)
    on_card, cfg = load_checkpoint(path)  # the default device is the card
    on_cpu, _ = load_checkpoint(path, device="cpu")
    assert on_card.pos.is_cuda and cfg == sim.cfg
    want = state_to_numpy(sim.state)
    for got in (state_to_numpy(on_card), state_to_numpy(on_cpu)):
        for f, v in want.items():
            np.testing.assert_array_equal(got[f], v, err_msg=f)
    resumed = Simulation.load(path)
    resumed.frame()
    assert resumed.state.pos.is_cuda and resumed.ensemble == 16


def test_cli_runs_on_the_card_by_default(dev, tmp_path, capsys):
    png = tmp_path / "o.png"
    before = force_step.launches
    assert cli.main(["--isotope", "C-14", "--frames", "3", "--time-scale", "1e9yr", "-q",
                     "--status-json", "--render", str(png), "--width", "160",
                     "--height", "120"]) == 0
    assert force_step.launches - before == 3 * 20
    out = capsys.readouterr().out
    assert '"backend": "cuda"' in out and png.read_bytes()[:4] == b"\x89PNG"


@pytest.mark.parametrize("size,zoom", [((320, 240), 15.0), ((160, 120), 4.0), ((64, 48), 100.0)])
def test_the_card_renders_what_the_cpu_renders(dev, size, zoom):
    sim = Simulation(z=92, n=146, pad_to=128, seed=0, device="cpu")
    for _ in range(3):
        sim.force_decay()
    cpu = render_to_host(sim.state, (400.0, 400.0), zoom, *size)
    card = render_to_host(sim.state.to(dev), (400.0, 400.0), zoom, *size)
    assert (cpu != card).any(-1).mean() <= 1e-3
    fit = sim.render_fit_device(64, 44)
    sim.state = sim.state.to(dev)
    assert (sim.render_fit_device(64, 44).cpu() == fit).float().mean() > 0.995


def _held_slots(sim):
    """Offsets, within the pinned flag buffer, of the flags that the frames
    in flight hold."""
    base = sim._nan_slots.data_ptr()
    return [f.nan.data_ptr() - base for f in sim._inflight]


def test_nan_flag_slots_stay_distinct_across_a_fused_run(dev):
    """Frames in flight, a fused run (which moves ``frame_count`` without
    dispatching a marker), more frames: no two frames in the queue ever
    share a pinned slot, and each flag reads back clean."""
    sim = Simulation(z=6, n=8, pad_to=8, ensemble=64, device=dev)
    sim.set_time_scale(3.15576e10)
    sim.nan_check_interval = 0
    steps = [sim.frame] * 3 + [lambda: sim.run(2, fused=True)] + [sim.frame] * 2 + [
        lambda: sim.run(5, fused=True)] + [sim.frame] * 6
    for step in steps:
        step()
        held = _held_slots(sim)
        assert len(set(held)) == len(held) == len(sim._inflight), held
    assert sim.frame_count == 11 + 7 and sim._markers_dispatched == 11
    torch.cuda.synchronize()
    assert not any(bool(f.nan) for f in sim._inflight)


def test_pipelined_reader_on_the_card(dev):
    """Pinned buffers allocated once, frames bitwise the blocking readback,
    none of it under a synchronising call; a raw frame handed out is valid
    until the next submit."""
    from pyqmd_tpu_torch.render import PipelinedFrameReader, render_frame_packed, unpack_frame

    sim = Simulation(z=6, n=8, pad_to=16, seed=2, device=dev)
    frames = [render_frame_packed(sim.state, (400.0 + i, 400.0), 6.0, 320, 240) for i in range(9)]
    want = [f.cpu().numpy() for f in frames]
    reader = PipelinedFrameReader(depth=3, decode=lambda a: a)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    def pinned():
        return [b.data_ptr() for ring, _ in reader._rings.values() for b in ring]

    got, kept, first_ring = [], [], None
    try:
        for f in frames:
            got.append(reader.submit(f))
            first_ring = first_ring or pinned()
            kept.append(None if got[-1] is None else got[-1].copy())  # while it is valid
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pinned() == first_ring and len(set(first_ring)) == 4  # allocated once
    assert [g is None for g in got] == [True] * 3 + [False] * 6
    # copied at hand-out, every frame is the blocking readback
    for g, w in zip(kept[3:], want):
        np.testing.assert_array_equal(g, w)
    # uncopied, only the newest is still whole: older buffers were reused
    np.testing.assert_array_equal(got[-1], want[5])
    assert any((g != w).any() for g, w in zip(got[3:-1], want))
    tail = reader.flush()
    assert len(tail) == 3
    for g, w in zip(tail, want[6:]):
        np.testing.assert_array_equal(unpack_frame(g), unpack_frame(w))
    assert pinned() == first_ring
    on_cpu = PipelinedFrameReader(depth=1)
    on_cpu.submit(frames[0].cpu())
    assert not on_cpu._rings and len(on_cpu.flush()) == 1


def test_packed_frame_on_the_card_is_the_cpu_packed_frame(dev):
    from pyqmd_tpu_torch.render import render_frame, render_frame_packed, unpack_frame

    sim = Simulation(z=92, n=146, pad_to=128, seed=0, device="cpu")
    for _ in range(3):
        sim.force_decay()
    cpu = render_frame_packed(sim.state, (400.0, 400.0), 15.0, 320, 240).numpy()
    state = sim.state.to(dev)
    card = render_frame_packed(state, (400.0, 400.0), 15.0, 320, 240).cpu().numpy()
    assert card[241, 0] == 1 and (card != cpu).mean() <= 1e-3
    np.testing.assert_array_equal(
        unpack_frame(card), render_frame(state, (400.0, 400.0), 15.0, 320, 240).cpu().numpy())
    with pytest.raises(ValueError):
        render_frame_packed(state, (400.0, 400.0), 15.0, 40, 30)


def test_viewer_threads_run_the_kernels_on_the_simulations_device(dev):
    """Handler threads step and draw a simulation that lives on the card."""
    import json
    import urllib.request

    from pyqmd_tpu_torch.render.httpview import LiveViewServer

    sim = Simulation(z=6, n=8, pad_to=16, device=dev)
    sim.set_preset("billion")
    srv = LiveViewServer(sim, port=0, fps=50, width=160, height=120)
    srv.start_background()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        before = force_step.launches
        req = urllib.request.urlopen(url + "/stream", timeout=60)
        buf = b""
        while buf.count(b"--pyqmd-frame") < 4:
            buf += req.read(1024)
        req.close()
        frames = sim.frame_count
        assert frames >= 3 and force_step.launches - before >= frames * 20
        status = json.loads(urllib.request.urlopen(url + "/status", timeout=60).read())
        assert status["backend"] == "cuda"
        assert urllib.request.urlopen(url + "/frame", timeout=60).read()[:4] == b"\x89PNG"
    finally:
        srv.close()


# --- the sharded path: a world of one on one card, NCCL ranks on several ---


@pytest.fixture
def world_of_one(dev):
    """``make_mesh()`` in a process with no group: NCCL rank 0 of 1 on the
    card; the group is destroyed after the test."""
    import torch.distributed as dist

    from pyqmd_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    try:
        assert (dist.get_world_size(), dist.get_backend()) == (1, "nccl")
        yield mesh
    finally:
        dist.destroy_process_group()


def _assert_states_equal(a, b):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_world_of_one_sharded_frames_are_the_bare_loops(dev, world_of_one):
    from pyqmd_tpu_torch import make_decay_frame_fn, make_frame_fn
    from pyqmd_tpu_torch.parallel import (
        make_sharded_decay_fn,
        make_sharded_frame_fn,
        make_sharded_run_fn,
        shard_ensemble,
    )

    cfg = SimConfig.for_isotope(92, 146, pad_to=128)
    init = ensemble_init(cfg, 64, seed=0, device=dev)
    a, fused = shard_ensemble(init, world_of_one), shard_ensemble(init, world_of_one)
    fn = make_sharded_frame_fn(cfg, 20, world_of_one)
    bare, b = make_frame_fn(cfg, 20, batched=True), init
    for _ in range(2):
        a, m = fn(a, 3.15576e18, 1 / 60.0)
        b, _ = bare(b, 3.15576e18, 1 / 60.0, cfg.effective_dt(), None)
    _assert_states_equal(a, b)
    assert int(m["survivors"]) == int(((a.z == 92) & (a.n == 146)).sum()) < 64
    fused, _ = make_sharded_run_fn(cfg, 20, 2, world_of_one)(fused, 3.15576e18, 1 / 60.0)
    _assert_states_equal(fused, a)

    c14 = SimConfig.for_isotope(6, 8, pad_to=8)
    init = ensemble_init(c14, 4096, seed=1, device=dev)
    a, m = make_sharded_decay_fn(c14, 10, world_of_one)(
        shard_ensemble(init, world_of_one), 1e11, 1.0)
    b, _ = make_decay_frame_fn(c14, 10)(init, 1e11, 1.0)
    _assert_states_equal(a, b)
    assert int(m["survivors"]) == int(((b.z == 6) & (b.n == 8)).sum())


def test_world_of_one_sharded_checkpoint(dev, world_of_one, tmp_path):
    from pyqmd_tpu_torch.parallel import make_sharded_frame_fn, shard_ensemble
    from pyqmd_tpu_torch.utils.checkpoint import load_checkpoint_sharded, save_checkpoint_sharded

    cfg = SimConfig.for_isotope(6, 8, pad_to=8)
    fn = make_sharded_frame_fn(cfg, 2, world_of_one)
    st, _ = fn(shard_ensemble(ensemble_init(cfg, 256, seed=0, device=dev), world_of_one),
               3.15576e16, 1 / 60.0)
    save_checkpoint_sharded(str(tmp_path / "ck"), st, cfg, world_of_one)
    back, cfg2 = load_checkpoint_sharded(str(tmp_path / "ck"), st, world_of_one)
    whole, _ = load_checkpoint_sharded(str(tmp_path / "ck"))  # the card by default
    assert cfg2 == cfg and back.pos.is_cuda and whole.pos.is_cuda
    _assert_states_equal(back, st)
    _assert_states_equal(whole, st)
    _assert_states_equal(fn(back, 3.15576e16, 1 / 60.0)[0], fn(st, 3.15576e16, 1 / 60.0)[0])


def _assert_graph_frames(res: dict) -> None:
    """The worker's ``graph_frames`` case on the cards: every replay of
    each factory bitwise its bare eager frame, one capture of one bucket,
    the launch counters moved as eager's (the ring's hop replaces the
    force kernel: overlap and the substep kernel only), no synchronising
    call in a replay."""
    for kind, r in res.items():
        assert r["differ"] == [], (kind, r["differ"])
        assert r["captures"] == r["buckets"] == 1, kind
        for got, eager in r["launches"]:
            assert got == eager, (kind, r["launches"])
        assert r["launches"][-1][1] == [0 if kind != "sharded" else 2, 0, 1, 2], kind


def test_world_of_one_graph_frames_replay_the_eager_frames(dev, world_of_one):
    """``make_sharded_frame_fn``, ``make_ring_frame_fn`` and
    ``make_hybrid_frame_fn`` on NCCL rank 0 of 1: the ring's collectives
    captured inside the graph, the aggregates reduced after the replay,
    each replay bitwise the eager frame across a change of time scale and
    frame interval."""
    from _torch_dist_worker import factories_against_eager

    _fresh_factories()
    _assert_graph_frames(factories_against_eager(1, dev))


@pytest.fixture(scope="module")
def nccl_ranks(tmp_path_factory):
    """``tests/_torch_dist_worker.py`` over min(cards, 4) NCCL ranks, one
    per card; skips below two cards."""
    import pickle
    import sys
    from pathlib import Path

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    world = min(torch.cuda.device_count(), 4)
    out = tmp_path_factory.mktemp("nccl")
    worker = Path(__file__).with_name("_torch_dist_worker.py")
    proc = subprocess.run(
        [sys.executable, str(worker), "--world", str(world), "--out", str(out), "--device", "cuda"],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return world, out, res


def test_nccl_sharded_frames_match_one_card(dev, nccl_ranks):
    """Each nucleus runs the same kernels whatever the batch around it, so
    the sharded frame, decay frame and fused run over N cards are bitwise
    one card's."""
    from _torch_dist_worker import gather

    from pyqmd_tpu_torch.core.step import decay_ensemble_step, ensemble_step

    world, _, res = nccl_ranks
    assert all(r["world_started"] == (world, "nccl") for r in res)
    c14 = SimConfig.for_isotope(6, 8, pad_to=8)
    one, _ = ensemble_step(ensemble_init(c14, 32, seed=0, device=dev), c14, 1.0, 1 / 60.0, 2)
    got = gather([r["sharded_frame"] for r in res], "state")
    for f, a in state_to_numpy(one).items():
        np.testing.assert_array_equal(got[f], a, err_msg=f)
    pb = SimConfig.for_isotope(82, 132, pad_to=8)
    one, _ = decay_ensemble_step(ensemble_init(pb, 32, seed=0, device=dev), pb, 400.0, 1.0, 4)
    got = gather([r["decay"] for r in res], "state")
    for f, a in state_to_numpy(one).items():
        np.testing.assert_array_equal(got[f], a, err_msg=f)
    assert int(res[0]["decay"]["survivors"]) == int(((got["z"] == 82) & (got["n"] == 132)).sum())
    loop, run = gather([r["run"] for r in res], "loop"), gather([r["run"] for r in res], "run")
    for f in loop:
        np.testing.assert_array_equal(run[f], loop[f], err_msg=f)


def test_nccl_ring_and_hybrid_match_the_kernel(dev, nccl_ranks):
    """The ring over N cards against the plain force and the hybrid frame
    against the kernel frame, exact math: integers equal, pos/vel within
    1e-4."""
    from _torch_dist_worker import gather

    from pyqmd_tpu_torch.core.init import init_state
    from pyqmd_tpu_torch.core.step import ensemble_step

    world, _, res = nccl_ranks
    fe = SimConfig.for_isotope(26, 30, pad_to=8, fast_math=False)
    st = init_state(fe, seed=0, device=dev)
    ref = force_step(st.pos, st.vel, st.ptype, st.alive, DT, fe)
    for r in res:
        np.testing.assert_allclose(r["ring_force"]["pos"], ref[0][0].cpu().numpy(), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(r["ring_force"]["vel"], ref[1][0].cpu().numpy(), atol=1e-4, rtol=1e-4)
    u = SimConfig.for_isotope(92, 146, pad_to=32, fast_math=False)
    dense, _ = ensemble_step(ensemble_init(u, 8, seed=0, device=dev), u, 3.15576e16, 1 / 60.0, 2)
    dense = state_to_numpy(dense)
    assert set(res[0]["hybrid"]) == {(world // m, m) for m in (1, 2, 4) if world % m == 0}
    for shape in res[0]["hybrid"]:
        got = gather([r["hybrid"][shape] for r in res], "state")
        for f in _torch_parity.INT_FIELDS:
            np.testing.assert_array_equal(got[f], dense[f], err_msg=(shape, f))
        for f in ("pos", "vel"):
            np.testing.assert_allclose(got[f], dense[f], atol=1e-4, rtol=1e-4, err_msg=str(shape))


def test_nccl_graph_frames_replay_the_eager_frames(dev, nccl_ranks):
    """The three factories over N cards: each rank's replays bitwise its
    eager frames, the ring's exchanges and gathers inside the graph; the
    ranks of a ``model`` group end with equal replicated fields."""
    from _torch_dist_worker import gather

    _, _, res = nccl_ranks
    for r in res:
        _assert_graph_frames(r["graph_frames"])
    for kind in ("sharded", "ring", "hybrid"):
        gather([r["graph_frames"][kind] for r in res], "state")


def test_nccl_sharded_checkpoint(dev, nccl_ranks):
    """Saved over N cards: restored bitwise on the same world, the next
    frame bitwise, and whole in this process, which has no group."""
    from _torch_dist_worker import gather

    from pyqmd_tpu_torch.utils.checkpoint import load_checkpoint_sharded

    _, out, res = nccl_ranks
    for layout in ("1d", "2d"):
        parts = [r["checkpoint"][layout] for r in res]
        saved = gather(parts, "saved")
        for p in parts:
            for f in p["saved"]:
                np.testing.assert_array_equal(p["restored"][f], p["saved"][f], err_msg=f)
                np.testing.assert_array_equal(p["next_restored"][f], p["next_saved"][f], err_msg=f)
        whole, _ = load_checkpoint_sharded(str(out / f"ck_{layout}"))
        for f, a in state_to_numpy(whole).items():
            np.testing.assert_array_equal(a, saved[f], err_msg=f)


# --- compiled frame buckets: CUDA graphs of the full-physics frame ---


GRAPH_CASES = [((92, 146), 128, 64), ((2, 2), 8, 256), ((92, 146), 128, 1)]


def _fresh_factories():
    """Empty factory caches, so a test sees its own captures."""
    from pyqmd_tpu_torch.core import step

    step.make_frame_fn.cache_clear()
    step.make_run_fn.cache_clear()
    return step


def _launches():
    return (force_step.launches, force_step.small_launches, overlap_step.launches,
            ejecta_decay_substep.launches)


@pytest.mark.parametrize("zn,pad_to,b", GRAPH_CASES)
def test_graph_frames_replay_the_eager_frames(dev, zn, pad_to, b):
    """Each replay against the bare eager frame, every field and metric
    bitwise: three frames, then a tenth of the time scale and another frame
    interval (one regime, no second capture), then the slow lifetime
    regime's bucket at two time scales; the launch counters move by the
    eager frame's launches (one substep kernel a substep); a replay makes
    no synchronising call."""
    step = _fresh_factories()
    cfg = SimConfig.for_isotope(*zn, pad_to=pad_to)
    batched = b > 1
    bare = step.ensemble_step if batched else step.simulate_frame
    fn = step.make_frame_fn(cfg, 20, batched)
    calls = [(3.15576e16, 1 / 60)] * 4 + [(3.15576e15, 1 / 60), (3.15576e16, 1 / 24)]
    got = want = ensemble_init(cfg, b, seed=7, device=dev)
    for i, (ts, fdt) in enumerate(calls):
        before = _launches()
        want, wm = bare(want, cfg, ts, fdt, 20, cfg.effective_dt(), cfg.physics_dt)
        eager = [a - c for a, c in zip(_launches(), before)]
        before = _launches()
        if i == 2:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            got, gm = fn(got, ts, fdt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert [a - c for a, c in zip(_launches(), before)] == eager, i
        _assert_states_equal(got, want)
        assert set(gm) == set(wm)
        for k in wm:
            assert torch.equal(gm[k], wm[k]), (i, k)
    assert fn.graphs.captures == 1 and len(fn.graphs.graphs) == 1
    assert eager[0] == 20 and eager[2] == 1 and eager[3] == 20
    # The other lifetime regime is a bucket of its own: its capture, then a
    # replay at a second time scale, each the eager frame bitwise.
    for ts in (0.5, 0.25):
        want, wm = bare(want, cfg, ts, 1 / 60, 20, cfg.effective_dt(), cfg.physics_dt)
        got, gm = fn(got, ts, 1 / 60)
        _assert_states_equal(got, want)
        for k in wm:
            assert torch.equal(gm[k], wm[k]), (ts, k)
    assert fn.graphs.captures == 2


@pytest.mark.parametrize("zn,pad_to,b", GRAPH_CASES)
def test_graph_run_is_k_eager_frames(dev, zn, pad_to, b):
    step = _fresh_factories()
    cfg = SimConfig.for_isotope(*zn, pad_to=pad_to)
    batched = b > 1
    bare = step.ensemble_step if batched else step.simulate_frame
    run = step.make_run_fn(cfg, 20, 3, batched)
    init = ensemble_init(cfg, b, seed=8, device=dev)
    want = init
    for _ in range(6):
        want, wm = bare(want, cfg, 3.15576e16, 1 / 60, 20, cfg.effective_dt(), cfg.physics_dt)
    got, _ = run(init, 3.15576e16, 1 / 60)  # the first frame eager, then the capture
    before = _launches()
    got, gm = run(got, 3.15576e16, 1 / 60)
    assert [a - c for a, c in zip(_launches(), before)] == [
        60, 60 * (cfg.max_particles <= 32), 3, 60]
    _assert_states_equal(got, want)
    for k in wm:
        assert torch.equal(gm[k], wm[k]), k
    assert run.graphs.captures == 1


def test_he4_ensemble_graph_frame_launches_only_the_sub_warp_force_kernel(dev):
    """One replayed frame of a He-4 ``Simulation(ensemble=64)`` at the
    billion preset (the benchmark's ``he4.ensemble.b10240`` at a smaller
    batch): 20 force launches by ``utils.profiling.counters()``, every one
    of them the sub-warp kernel, none the tiled one; every field and metric
    bitwise the eager frame from the same state."""
    step = _fresh_factories()
    sim = Simulation(z=2, n=2, seed=17, ensemble=64, pad_to=8, device=dev)
    sim.set_preset("billion")
    sim.frame()  # the bucket's first call: an eager frame, then the capture
    state = sim.state
    before = profiling.counters()
    metrics = sim.frame()
    grown = {k: v - before[k] for k, v in profiling.counters().items()}
    assert grown["graph.replays"] == 1 and grown["graph.captures"] == 0
    assert grown["kernels.force_step.small_launches"] == 20
    assert grown["kernels.force_step.launches"] == 20  # of either kernel: none tiled
    assert sim.substeps_used == 20
    want, wm = step.ensemble_step(state, sim.cfg, sim.time_scale, 1 / 60, 20,
                                  sim.cfg.effective_dt(), sim.cfg.physics_dt)
    _assert_states_equal(sim.state, want)
    assert set(metrics) == set(wm)
    for k in wm:
        assert torch.equal(metrics[k], wm[k]), k


def test_graph_replay_spans_and_one_capture_per_bucket(dev):
    """A replayed frame is the spans ``pyqmd.graph.copy_in``, ``replay`` and
    ``copy_out``, the copies' device operations launched inside the copy
    spans; ``graph.captures`` rises once per bucket and not on replays."""
    from torch.profiler import ProfilerActivity, profile

    step = _fresh_factories()
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    fn = step.make_frame_fn(cfg, 20, True)
    st = ensemble_init(cfg, 256, seed=3, device=dev)
    before = profiling.counters()
    st, _ = fn(st, 3.15576e16, 1 / 60)  # the warm-up frame, then the capture
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            st, _ = fn(st, 3.15576e16, 1 / 60)
        torch.cuda.synchronize()
    grown = {k: v - before[k] for k, v in profiling.counters().items()}
    assert grown["graph.captures"] == 1 and grown["graph.replays"] == 3
    # each span twice: on the host, and as the device's range of its operations
    spans = [(e.name, e.device_type) for e in prof.events() if e.name.startswith("pyqmd.")]
    host = [n for n, d in spans if d == torch.autograd.DeviceType.CPU]
    assert host == ["pyqmd.graph.copy_in", "pyqmd.graph.replay", "pyqmd.graph.copy_out"] * 3
    assert sorted(n for n, d in spans if d != torch.autograd.DeviceType.CPU) == sorted(host)
    fn(st, 0.5, 1 / 60)  # the other lifetime regime: a bucket of its own
    assert profiling.counters()["graph.captures"] - before["graph.captures"] == 2


def test_simulation_waits_on_the_card_are_counted(dev):
    """Eight frames of one nucleus: the retire fence waits from the fourth
    frame on, once a frame; no NaN guard and no drain fall in them."""
    sim = Simulation(z=92, n=146, device=dev)
    sim.set_preset("billion")
    before = profiling.counters()
    for _ in range(8):
        sim.frame()
    grown = {k: v - before[k] for k, v in profiling.counters().items()}
    assert grown["host.syncs"] == 5 and grown["sim.chain_drains"] == 0


def test_graph_results_are_fresh_tensors(dev):
    """A returned state stays as it was after later replays."""
    step = _fresh_factories()
    cfg = SimConfig.for_isotope(92, 146, pad_to=128)
    fn = step.make_frame_fn(cfg, 4, True)
    st = ensemble_init(cfg, 16, seed=2, device=dev)
    kept = []
    for _ in range(4):
        st, _ = fn(st, 3.15576e16, 1 / 60)
        kept.append((st, state_to_numpy(st)))
    for s, copy in kept:
        for f, a in state_to_numpy(s).items():
            np.testing.assert_array_equal(a, copy[f], err_msg=f)


def test_a_failed_capture_raises_and_names_the_bucket(dev):
    """A frame that synchronises cannot be captured: the first call raises
    and names the bucket (in a process of its own, which the failed
    capture leaves in a state no later test should inherit)."""
    import sys
    from pathlib import Path

    probe = (
        "import torch\n"
        "from pyqmd_tpu_torch import SimConfig, ensemble_init\n"
        "from pyqmd_tpu_torch.core import step\n"
        "real = step._ensemble_metrics\n"
        "def syncing(st):\n"
        "    m = real(st)\n"
        "    m['alive_on_host'] = torch.full((), int(m['total_alive']))\n"
        "    return m\n"
        "step._ensemble_metrics = syncing\n"
        "cfg = SimConfig.for_isotope(2, 2, pad_to=8)\n"
        "fn = step.make_frame_fn(cfg, 4, True)\n"
        "try:\n"
        "    fn(ensemble_init(cfg, 8, device='cuda'), 3.15576e16, 1 / 60)\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
        "else:\n"
        "    print('no error')\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=300, cwd=str(Path(__file__).resolve().parent.parent))
    assert "raised: capture of the frame graph of bucket (Z=2, N=2, P=8, num_steps=4" in (
        proc.stdout), proc.stdout + proc.stderr


def test_a_kernel_opted_into_shared_memory_before_a_capture_replays(dev):
    """The tiled force kernel at P=600 needs the shared-memory opt-in
    (its static arrays take the block past 48 KB): the launch before the
    capture makes the cudaFuncSetAttribute call (once per device and
    size), so the captured launch makes none and replays the eager
    launch's bits. In a process of its own, so that no earlier test has
    opted in."""
    import sys
    from pathlib import Path

    probe = (
        "import torch\n"
        "from pyqmd_tpu_torch.config import SimConfig\n"
        "from pyqmd_tpu_torch.kernels.forces import force_step\n"
        "cfg = SimConfig.for_isotope(92, 146, pad_to=600, fast_math=False)\n"
        "g = torch.Generator().manual_seed(0)\n"
        "d = 'cuda'\n"
        "pos = (400 + 60 * torch.rand(4, 600, 2, generator=g)).to(d)\n"
        "vel = torch.randn(4, 600, 2, generator=g).to(d)\n"
        "ptype = torch.randint(0, 2, (4, 600), generator=g, dtype=torch.int32).to(d)\n"
        "alive = (torch.rand(4, 600, generator=g) < 0.9).to(d)\n"
        "dt = torch.full((), 1 / 240, device=d)\n"
        "want = force_step(pos, vel, ptype, alive, dt, cfg)\n"
        "graph = torch.cuda.CUDAGraph()\n"
        "with torch.cuda.graph(graph):\n"
        "    got = force_step(pos, vel, ptype, alive, dt, cfg)\n"
        "graph.replay()\n"
        "torch.cuda.synchronize()\n"
        "print('replayed equal:', torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=300, cwd=str(Path(__file__).resolve().parent.parent))
    assert "replayed equal: True" in proc.stdout, proc.stdout + proc.stderr
