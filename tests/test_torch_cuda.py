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
