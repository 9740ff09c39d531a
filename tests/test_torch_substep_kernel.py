"""The full-physics substep kernel's CUDA source (``csrc/substep.cu``), run on
the CPU, against the plain ``advance_ejecta`` + ``maybe_decay``.

The source is compiled with g++ against ``tests/cuda_emulation.h`` (one
std::thread per CUDA thread, a warp's ballots and shuffles at a barrier of
its 32 threads), so the warp-per-nucleus schedule, the ballot ranks and the
centre of mass's butterfly run as written. Each case runs a frame's first
two substeps in place on a copy of the state, each against the plain
version from the same state under the substep key of the frame's key
split. Every integer field (alive, ptype, counts, the chain ring, the
ejecta ring's types, alive flags and cursor) is bitwise equal; floats go
through exp, log, cos and sin, which glibc and torch's vectorised CPU
kernels round differently, and the centre of mass is summed in another
order: 1e-6 relative for the decay engine's floats, the force kernels'
bar (rtol = atol = 1e-4) for positions and velocities.

The data tables decay nothing by fission or neutron emission, so those
cases patch a row of the packed table, which the plain version and the
kernel both read. Half-lives are set so that a chosen share of the batch
decays for certain (p = 1) and the rest never (p = 0) or far from a tie.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_parity as tp
from pyqmd_tpu_torch import prng
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import decay
from pyqmd_tpu_torch.core.dynamics import frame_dynamics, frame_scalars
from pyqmd_tpu_torch.core.init import mixed_ensemble_init
from pyqmd_tpu_torch.data import tables
from pyqmd_tpu_torch.kernels import substep as ksub
from pyqmd_tpu_torch.state import state_to_numpy
from pyqmd_tpu_torch.utils import profiling

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "pyqmd_tpu_torch" / "csrc"
YEAR = 3.15576e7
STEPS = 20

INT_FIELDS = ("alive", "ptype", "z", "n", "decay_counts", "chain_z0", "chain_n0", "chain_dtype",
              "chain_z1", "chain_n1", "chain_cursor", "ej_type", "ej_alive", "ej_cursor")
CLOCK_FLOATS = ("half_life", "last_decay_time", "chain_time", "ej_age", "ej_life")
WORLD_FLOATS = ("vel", "ej_pos", "ej_vel")

# name: (species (Z, N, count), P, E, C, fragments per event, fast lifetimes,
#        table patch {(Z, N): decay type of both branches}, modes that must occur)
CASES = {
    # Nothing decays: the ring advances and expires, every other field stays.
    "no_decay": ([(92, 146, 11)], 256, 64, 8, 3, True, {}, set()),
    # α at P=256 (8 chunks of ballots), the 64-slot ring, fast lifetimes.
    "alpha": ([(92, 146, 13)], 256, 64, 8, 3, True, {}, {1}),
    # β-, β+ and γ beside α; E = 40 (not a multiple of 32), slow lifetimes,
    # a 5-slot chain ring, B = 15 (the last block's warps past the batch).
    "mixed_slow": ([(92, 146, 4), (6, 8, 4), (47, 56, 4), (43, 56, 3)], 256, 40, 5, 3, False,
                   {}, {1, 2, 3, 4}),
    # P = 8: β- and p-emission on one partial chunk; E = 20 < 32.
    "p8": ([(1, 2, 5), (2, 6, 4), (4, 3, 4)], 8, 20, 4, 3, True, {}, {2, 6}),
    # Fission, 2 and 3 fragments into a ring whose cursor wraps.
    "fission": ([(82, 132, 17)], 256, 64, 8, 3, True, {(82, 132): 7}, {7}),
    # Fission with two fragment slots per event: the third is dropped.
    "fission_two_slots": ([(82, 132, 9)], 256, 33, 3, 2, False, {(82, 132): 7}, {7}),
    # Fission into a 2-slot ring: a third fragment has no slot (the cursor
    # still counts it).
    "fission_tiny_ring": ([(82, 132, 9)], 256, 2, 4, 3, True, {(82, 132): 7}, {7}),
    # Neutron emission: one neutron removed, velocities damped.
    "n_emission": ([(92, 146, 10)], 256, 64, 6, 3, True, {(92, 146): 5}, {5}),
}


def _emulated_source(path: Path) -> str:
    return re.sub(r"(\w+)<<<(.*?)>>>\(", r"pq_launch(\1, \2, ", path.read_text(), flags=re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("substep")
    (d / "cuda_runtime.h").write_text(f'#include "{HERE / "cuda_emulation.h"}"\n')
    (d / "substep.cpp").write_text(_emulated_source(CSRC / "substep.cu"))
    out = d / "libsubstep.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", f"-I{d}",
         f"-I{CSRC}", "-include", str(HERE / "cuda_emulation.h"), str(d / "substep.cpp"),
         "-o", str(out), "-lpthread"],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    lib.pyqmd_ejecta_decay_substep.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _launch(lib, st, cfg, sc, k3, s):
    """The kernel's entry point on CPU tensors, as the wrapper calls it: it
    updates ``st``'s tensors in place."""
    b, p = st.alive.shape
    args = ksub._Args(
        f=ksub._fields(st), pos=st.pos.data_ptr(),
        time_passed=st.time_passed.data_ptr(), k3=k3.data_ptr(),
        rows=tables.rows_on("cpu").data_ptr(), step_time=sc.step_time.data_ptr(),
        anim_step=sc.anim_step.data_ptr(), nucleon_step=sc.nucleon_step.data_ptr(),
        anim_age_inc=sc.anim_age_inc.data_ptr(), ejecta_life=sc.ejecta_life.data_ptr(),
        batch=b, particles=p, ejecta=st.ej_type.shape[1], chain=st.chain_time.shape[1],
        per_event=cfg.max_ejecta_per_event, step=s, fast_lifetimes=int(sc.fast_lifetimes),
        decay_damping=cfg.decay_damping,
    )
    assert lib.pyqmd_ejecta_decay_substep(ctypes.addressof(args), None) == 0


def _state(case, g):
    species, p, e, c, k_e, fast, _, modes = CASES[case]
    z, n, _ = species[0]
    cfg = SimConfig(z=z, n=n, max_particles=p, max_ejecta=e, max_chain_log=c,
                    max_ejecta_per_event=k_e)
    st = mixed_ensemble_init(cfg, species, seed=len(case), device="cpu")
    b = st.batch
    ts = 1e9 * YEAR if fast else 0.5
    sc = frame_scalars(frame_dynamics(cfg, ts, 1 / 60, STEPS, None, cfg.physics_dt), cfg, "cpu")
    assert sc.fast_lifetimes == fast
    step_time = float(sc.step_time)
    # A ring in use: live and dead slots, ages about to pass their lifetimes.
    types = torch.from_numpy(g.integers(0, 6, (b, e)).astype(np.int32))
    life = torch.from_numpy(g.uniform(0.1, 3.0, (b, e)).astype(np.float32))
    life[types < 2] = float("inf")
    age = life * torch.from_numpy(g.uniform(0.5, 1.05, (b, e)).astype(np.float32))
    age[types < 2] = torch.from_numpy(g.uniform(0, 1e9, (b, e)).astype(np.float32))[types < 2]
    # Two thirds of the members decay for certain (p = 1); the others never
    # (stable, or p < 1e-4 without a decay) or, where decays are wanted, at
    # p = 0.07-1 away from a tie.
    hl = step_time * 10.0 ** (g.uniform(-1, 1, b) if modes else g.uniform(4, 6, b))
    hl[g.uniform(size=b) < 0.25] = np.inf
    if modes:
        hl[g.permutation(b)[: (2 * b) // 3]] = step_time * 1e-3
    tp_ = np.full(b, 3e9 if fast else 40.0)
    st = st.replace(
        vel=torch.from_numpy(g.normal(0, 2, (b, p, 2)).astype(np.float32)),
        ej_pos=torch.from_numpy(g.normal(400, 30, (b, e, 2)).astype(np.float32)),
        ej_vel=torch.from_numpy(g.normal(0, 20, (b, e, 2)).astype(np.float32)),
        ej_type=types, ej_age=age, ej_life=life,
        ej_alive=torch.from_numpy(g.uniform(size=(b, e)) < 0.7),
        ej_cursor=torch.from_numpy(g.integers(0, 5 * e, b).astype(np.int32)),
        half_life=torch.from_numpy(hl.astype(np.float32)),
        time_passed=torch.from_numpy(tp_.astype(np.float32)),
        last_decay_time=torch.from_numpy(np.where(g.uniform(size=b) < 0.5, 0.0, tp_)
                                         .astype(np.float32)),
        chain_cursor=torch.from_numpy(g.integers(0, 3 * c, b).astype(np.int32)),
    )
    st.ej_cursor[: b // 2] = e - 1  # fragments wrap the ring
    return cfg, st, sc


def _plain(st, cfg, sc, k3, s):
    keys = prng.split(k3[:, 0], STEPS)[:, s]
    u0 = prng.uniform(keys, (1,))[:, 0]
    p = decay.decay_probability(st.half_life, sc.step_time)
    ties = (torch.abs(u0 - p) <= 4 * torch.finfo(torch.float32).eps * p) & (p < 1)
    assert not ties.any(), "a draw sits at its probability"
    return decay.maybe_decay(decay.advance_ejecta(st, cfg, sc), cfg, keys, sc)[0]


def _assert_matches(got, want, case):
    g, w = state_to_numpy(got), state_to_numpy(want)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(g[f], w[f], err_msg=f"{case}: {f}")
    for f in CLOCK_FLOATS:
        tp.assert_rel_close(g[f], w[f], 1e-6, f"{case}: {f}")
    for f in WORLD_FLOATS:
        np.testing.assert_allclose(g[f], w[f], rtol=1e-4, atol=1e-4, err_msg=f"{case}: {f}")
    for f in ("pos", "time_passed", "rng"):
        np.testing.assert_array_equal(g[f], w[f], err_msg=f"{case}: {f}")


def _clone(st):
    return st.replace(**{f: getattr(st, f).clone() for f in ksub.SUBSTEP_FIELDS})


@pytest.mark.parametrize("case", sorted(CASES))
def test_substep_kernel_source_matches_plain(lib, case, monkeypatch):
    """The frame's first substep, then the next one, in place on a copy of
    the state, each against the plain version from the same state."""
    species, p, e, c, k_e, fast, patch, modes = CASES[case]
    if patch:
        rows = tables._ROWS.copy()
        for (z, n), mode in patch.items():
            rows[z * tables.N_DIM + n, [8, 11]] = mode
        monkeypatch.setattr(tables, "_ROWS", rows)
    g = np.random.default_rng(sum(map(ord, case)))
    cfg, st, sc = _state(case, g)
    k3 = prng.split(torch.from_numpy(g.integers(0, 2**32, (st.batch, 2), dtype=np.int64)), 3)
    kept = state_to_numpy(st)

    want = _plain(st, cfg, sc, k3, 0)
    got = _clone(st)
    _launch(lib, got, cfg, sc, k3, 0)
    _assert_matches(got, want, case)
    for f, a in state_to_numpy(st).items():  # the copy's tensors only
        np.testing.assert_array_equal(a, kept[f], err_msg=f)

    # The next substep, from the first one's outputs.
    want2 = _plain(want, cfg, sc, k3, 1)
    _launch(lib, got, cfg, sc, k3, 1)
    _assert_matches(got, want2, case)

    fired = want.chain_cursor - st.chain_cursor
    slot = (st.chain_cursor % c).long()[:, None]
    seen = set(torch.gather(want.chain_dtype, 1, slot)[:, 0][fired > 0].tolist())
    assert seen == modes, (case, seen)
    assert int((want.ej_alive != st.ej_alive).sum()) > 0  # expiries and fragments
    if not modes:
        for f in ("z", "n", "half_life", "decay_counts", "chain_cursor", "vel", "alive"):
            assert torch.equal(getattr(want, f), getattr(st, f)), f
    added = (want.ej_cursor - st.ej_cursor)[fired > 0]
    if 7 in modes:
        assert set(added.tolist()) == ({2} if k_e == 2 else {2, 3})
    elif modes:
        assert set(added.tolist()) == {1}
    if modes & {1, 5, 6}:  # removals and damping
        assert int((want.alive != st.alive).sum()) > 0
        assert not torch.equal(want.vel, st.vel)
    if modes & {2, 3}:  # β flips
        assert int((want.ptype != st.ptype).sum()) > 0
    wrapped = (st.chain_cursor % c + fired) >= c
    assert bool(wrapped.any()) or not modes  # the chain ring wraps


def test_cpu_wrapper_is_the_plain_substep():
    """On CPU tensors the wrapper runs advance_ejecta + maybe_decay under
    split(k3[:, 0], S)[:, s] (fold_in(k, s) is that key) into new tensors,
    leaving its input as it was."""
    g = np.random.default_rng(5)
    cfg, st, sc = _state("mixed_slow", g)
    k3 = prng.split(torch.from_numpy(g.integers(0, 2**32, (st.batch, 2), dtype=np.int64)), 3)
    assert torch.equal(prng.fold_in(k3[:, 0], 7), prng.split(k3[:, 0], STEPS)[:, 7])
    want = _plain(st, cfg, sc, k3, 3)
    kept = state_to_numpy(st)
    before = profiling.counters()["kernels.ejecta_decay_substep.launches"]
    got = ksub.ejecta_decay_substep(st, cfg, sc, k3, 3)
    for f, a in state_to_numpy(want).items():
        np.testing.assert_array_equal(state_to_numpy(got)[f], a, err_msg=f)
    for f, a in state_to_numpy(st).items():
        np.testing.assert_array_equal(a, kept[f], err_msg=f)
    assert profiling.counters()["kernels.ejecta_decay_substep.launches"] == before  # none ran
