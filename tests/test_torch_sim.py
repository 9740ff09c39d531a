"""The port's ``Simulation`` against the JAX package's ``Simulation`` on the
same seeds: the substep scheduler (equal), frames single and ensemble
(integer fields and rng bitwise, floats rtol = atol = 1e-4), fused runs
(bitwise equal to the frame loop in the port), forced decays and the decay
log (bitwise, equal strings), ``status()`` key for key, the chain log and
its drain cadence, and the controls."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import _torch_parity as tp
from pyqmd_tpu import sim as jax_sim
from pyqmd_tpu.sim import Simulation as JaxSimulation
from pyqmd_tpu_torch import Simulation, make_run_fn, sim as port_sim
from pyqmd_tpu_torch.core import step
from pyqmd_tpu_torch.sim import ISOTOPE_KEYMAP, TIME_SCALE_PRESETS
from pyqmd_tpu_torch.state import NucleusState, state_to_numpy

FIELDS = [f.name for f in dataclasses.fields(NucleusState)]
FLOAT_FIELDS = [f for f in FIELDS if f not in tp.INT_FIELDS]
TOL = 1e-4


def _pair(z, n, pad_to, seed=0, ensemble=None, **kw):
    jsim = JaxSimulation(z=z, n=n, seed=seed, pad_to=pad_to, ensemble=ensemble, **kw)
    sim = Simulation(z=z, n=n, seed=seed, pad_to=pad_to, ensemble=ensemble, device="cpu", **kw)
    return jsim, sim


def _ref_arrays(jsim):
    ref = tp.jax_to_numpy(jsim.state)
    return ref if jsim.batched else tp.batch_of_one(ref)


def _compare_states(jsim, sim, tol=TOL, floats=True):
    ref, got = _ref_arrays(jsim), state_to_numpy(sim.state)
    for f in tp.INT_FIELDS:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    if floats:
        for f in FLOAT_FIELDS:
            np.testing.assert_allclose(got[f], ref[f], rtol=tol, atol=tol, err_msg=f)


# --- the scheduler -----------------------------------------------------------

TIME_SCALES = [1e-40, 1e-30, 1e-12, 1e-3, 0.5, 1.0, 2.0, 9.99, 10.0, 10.01, 60.0, 3600.0, 1e5,
               31557600.0, 1e12, 3.15576e16, 1e22, 1e30]


@pytest.mark.parametrize("auto", [False, True])
def test_schedule_equals_the_reference_over_the_grid(auto):
    jsim, sim = _pair(2, 2, 8)
    for ts, acc, ms, fdt in itertools.product(
            TIME_SCALES, (1.0, 0.5, 0.0, 1.9), (1, 7, 20, 33), (1 / 60, 7 / 240, 1 / 24)):
        for s in (jsim, sim):
            s.time_scale = ts
            s.accuracy = acc
            s.max_substeps = ms
            s.physics_dt = s.cfg.physics_dt
            s.auto_adjust_substeps = auto
        assert sim._schedule(fdt) == jsim._schedule(fdt), (ts, acc, ms, fdt)
        assert sim.physics_dt == jsim.physics_dt  # auto-adjust stores its timestep
    assert sim._SUBSTEP_LADDER == jsim._SUBSTEP_LADDER


def test_substeps_exact_without_auto_adjust():
    sim = Simulation(z=2, n=2, pad_to=8, device="cpu")
    num, _ = sim._schedule(7.0 / 240.0)
    assert num == 7
    sim.auto_adjust_substeps = True
    sim.time_scale = 1.0
    assert sim._schedule(7.0 / 240.0)[0] == 6  # the ladder applies only in auto mode


# --- frames ------------------------------------------------------------------

@pytest.mark.parametrize("zn,pad_to,ensemble,ts,frames", [
    ((2, 2), 8, None, 1.0, 4),
    ((6, 8), 8, None, 3.15576e10, 3),
    ((92, 146), 128, None, TIME_SCALE_PRESETS["billion"], 2),
    ((6, 8), 8, 8, 3.15576e11, 3),
    ((2, 2), 8, 8, 1.0, 3),
])
def test_frames_equal_the_reference(zn, pad_to, ensemble, ts, frames):
    jsim, sim = _pair(*zn, pad_to, seed=1, ensemble=ensemble)
    _compare_states(jsim, sim)
    for s in (jsim, sim):
        s.set_time_scale(ts)
    for f in range(frames):
        jm, m = jsim.frame(), sim.frame()
        assert sim.substeps_used == jsim.substeps_used
        # positions are chaotic: held to the tolerance on the first frames
        _compare_states(jsim, sim, floats=f < 2 or zn == (2, 2))
        for k in ("alive", "z", "n", "decay_counts", "chain_cursor", "nan"):
            np.testing.assert_array_equal(m[k].numpy().reshape(-1),
                                          np.asarray(jm[k]).reshape(-1), err_msg=k)
        assert set(m) == set(jm)
    assert sim.frame_count == jsim.frame_count == frames
    assert sim.isotope == jsim.isotope
    assert sim.camera == jsim.camera and sim.zoom == jsim.zoom


@pytest.mark.parametrize("ensemble", [None, 4])
def test_fused_run_is_bitwise_the_frame_loop_and_matches_the_reference(ensemble):
    looped = Simulation(z=6, n=8, seed=2, pad_to=8, ensemble=ensemble, device="cpu")
    fused = Simulation(z=6, n=8, seed=2, pad_to=8, ensemble=ensemble, device="cpu")
    jsim = JaxSimulation(z=6, n=8, seed=2, pad_to=8, ensemble=ensemble)
    for s in (looped, fused, jsim):
        s.set_time_scale(3.15576e12)
    for _ in range(10):
        looped.frame()
    m = fused.run(10, fused=True)
    jm = jsim.run(10, fused=True)
    a, b = state_to_numpy(looped.state), state_to_numpy(fused.state)
    for f in FIELDS:
        np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    for k, v in looped.last_metrics.items():
        assert torch.equal(m[k], v), k
    assert fused.frame_count == 10 and fused.substeps_used == looped.substeps_used
    assert int(m["decay_counts"].sum()) > 0
    _compare_states(jsim, fused, floats=False)
    assert set(m) == set(jm)
    if ensemble is None:
        assert fused.decay_log == looped.decay_log == jsim.decay_log
        assert len(fused.decay_log) > 0
    # the unfused form of run() is the frame loop, and returns its metrics
    again = Simulation(z=6, n=8, seed=2, pad_to=8, ensemble=ensemble, device="cpu")
    again.set_time_scale(3.15576e12)
    assert again.run(0) is None
    last = again.run(10)
    assert torch.equal(last["z"], looped.last_metrics["z"]) and again.run(0) is last


def test_make_run_fn_computes_metrics_once_on_the_final_state(monkeypatch):
    calls = []
    real = step.state_metrics
    monkeypatch.setattr(step, "state_metrics", lambda st: calls.append(1) or real(st))
    sim = Simulation(z=2, n=2, pad_to=8, ensemble=3, device="cpu")
    fn = make_run_fn(sim.cfg, 4, 5, batched=True)
    state, m = fn(sim.state, 1.0, 1 / 60)
    assert len(calls) == 1 and "total_alive" in m
    np.testing.assert_allclose(state.time_passed.numpy(), 5 * np.float32(1 / 60), rtol=1e-6)
    with pytest.raises(ValueError):
        make_run_fn(sim.cfg, 4, 1, batched=False)(sim.state, 1.0, 1 / 60)


def test_an_exception_in_the_frame_function_reaches_the_caller(monkeypatch):
    """No fallback and no retry: the error leaves ``frame()`` and the state
    is still the pre-frame state."""
    sim = Simulation(z=6, n=8, pad_to=8, device="cpu")
    sim.frame()
    before, count = sim.state, sim.frame_count

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(step, "force_step", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        sim.frame()
    assert sim.state is before and sim.frame_count == count
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        sim.run(3, fused=True)
    assert sim.state is before
    monkeypatch.undo()
    sim.frame()  # and it goes on once the fault is gone
    assert sim.frame_count == count + 1
    assert not hasattr(sim, "force_backend") and not hasattr(sim.cfg, "force_backend")


# --- forced decays and the log -------------------------------------------------

@pytest.mark.parametrize("zn,pad_to,decays", [((92, 146), 128, 5), ((6, 8), 16, 2), ((82, 132), 8, 4)])
def test_force_decay_is_bitwise_the_reference(zn, pad_to, decays):
    jsim, sim = _pair(*zn, pad_to, seed=0)
    sim.state = tp.to_port_single(jsim.state)  # the same floats to start from
    for s in (jsim, sim):
        s.set_time_scale(1e6)
    for _ in range(decays):
        jsim.force_decay()
        sim.force_decay()
    ref, got = _ref_arrays(jsim), state_to_numpy(sim.state)
    for f in FIELDS:
        if f in ("ej_pos", "ej_vel", "half_life"):  # sin/cos/exp2 round per library
            np.testing.assert_allclose(got[f], ref[f], rtol=1e-6, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    # a stable daughter (N-14) takes no further decay, in either package
    assert sim.decay_log == jsim.decay_log and 1 <= len(sim.decay_log) <= decays
    assert sim.isotope == jsim.isotope
    assert sim.chain_entries() == jsim.chain_entries()


def test_force_decay_logs_and_reset_clears_them():
    sim = Simulation(z=92, n=146, seed=0, pad_to=128, device="cpu")
    sim.force_decay()
    assert len(sim.decay_log) == 1 and "U-238 → Th-234 (α)" in sim.decay_log[0]
    assert sim.isotope == "Th-234"
    e = sim.chain_entries()[-1]
    assert e["parent"] == (92, 146) and e["child"] == (90, 144)
    sim.reset(z=6, n=8)
    assert sim.decay_log == [] and sim.isotope == "C-14"


def test_decay_log_of_a_run_equals_the_reference():
    jsim, sim = _pair(92, 146, 128, seed=0)
    for s in (jsim, sim):
        s.set_time_scale(3.15576e18)  # 1e11 years per second: the chain runs down
        for _ in range(12):
            s.frame()
    assert len(jsim.decay_log) > 3
    assert sim.decay_log == jsim.decay_log
    # durations come from a log of a draw, which rounds per library
    for e, je in zip(sim.chain_entries(), jsim.chain_entries(), strict=True):
        assert e["duration"] == pytest.approx(je["duration"], rel=1e-5)
        assert {**e, "duration": 0} == {**je, "duration": 0}
    assert sim.status()["decay_counts"] == jsim.status()["decay_counts"]


def test_an_ensemble_of_one_is_still_an_ensemble():
    sim = Simulation(z=6, n=8, pad_to=8, ensemble=1, device="cpu")
    m = sim.frame()
    assert sim.batched and sim.state.batch == 1 and "total_alive" in m
    assert sim.cfg.max_chain_log == 64 and sim.isotope == "C-14 x1"
    with pytest.raises(RuntimeError):
        sim.force_decay()
    with pytest.raises(RuntimeError):
        sim.chain_entries()
    assert sim.decay_log == []
    single = Simulation(z=6, n=8, pad_to=8, device="cpu")
    assert not single.batched and single.cfg.max_chain_log == 256
    assert "total_alive" not in single.frame()


def test_ensemble_mode():
    jsim, sim = _pair(6, 8, 8, ensemble=8)
    m = sim.frame()
    jsim.frame()
    assert sim.batched and int(m["total_alive"]) == 8 * 14
    s, js = sim.status(), jsim.status()
    assert s["ensemble"] == 8 and set(s) == set(js)
    for k in ("isotope", "alive", "decay_counts", "time_scale", "substeps"):
        assert s[k] == js[k], k


# --- status --------------------------------------------------------------------

def test_status_equals_the_reference_key_for_key():
    jsim, sim = _pair(6, 8, 16)
    for s in (jsim, sim):
        s.set_time_scale(3.15576e10)
        for _ in range(3):
            s.frame()
    s, js = sim.status(), jsim.status()
    assert list(s) == list(js)
    for k in ("isotope", "z", "n", "element", "alive", "ejecta", "decay_counts", "time_passed",
              "time_scale", "substeps", "physics_dt", "auto_adjust", "zoom", "half_life"):
        assert s[k] == js[k], k
    for k in ("rms_radius", "kinetic_energy"):
        np.testing.assert_allclose(s[k], js[k], rtol=TOL, atol=TOL, err_msg=k)
    assert s["backend"] == "cpu"  # the device type; the port has no backend switch
    st = sim.state
    assert s["alive"] == int(st.alive_count()[0]) and s["ejecta"] == int(st.ej_alive.sum())
    assert s["half_life"] == float(st.half_life[0]) and s["time_passed"] == float(st.time_passed[0])
    np.testing.assert_allclose(s["rms_radius"], float(st.rms_radius()[0]), rtol=1e-6)
    np.testing.assert_allclose(s["kinetic_energy"], float(st.kinetic_energy()[0]), rtol=1e-6)


@pytest.mark.parametrize("ensemble", [None, 4])
def test_status_and_chain_log_cost_one_transfer_each(monkeypatch, ensemble):
    """status() is one packed readback; chain_entries() the cursor and one
    pack; neither reads a scalar per field."""
    sim = Simulation(z=92, n=146, pad_to=128, ensemble=ensemble, device="cpu")
    if not ensemble:
        sim.force_decay()
    counts = {"cpu": 0, "scalar": 0}
    real_cpu = torch.Tensor.cpu

    def cpu(self, *a, **k):
        counts["cpu"] += 1
        return real_cpu(self, *a, **k)

    def scalar(name):
        real = getattr(torch.Tensor, name)

        def f(self, *a, **k):
            counts["scalar"] += 1
            return real(self, *a, **k)
        return f

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    for name in ("item", "__int__", "__float__", "__bool__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, scalar(name))
    sim.status()
    assert counts == {"cpu": 1, "scalar": 0}  # chain cache hit: drained by force_decay
    if not ensemble:
        sim._chain_cache = None
        counts.update(cpu=0, scalar=0)
        sim.status()  # the cursor rides in the status pack, the ring is one more
        assert counts == {"cpu": 2, "scalar": 0}
        sim._chain_cache = None
        counts.update(cpu=0, scalar=0)
        entries = sim.chain_entries()
        assert counts == {"cpu": 1, "scalar": 1} and len(entries) == 2
        counts.update(cpu=0, scalar=0)
        assert sim.chain_entries() is entries  # cached by cursor
        assert counts == {"cpu": 0, "scalar": 1}


def test_status_pack_layout():
    sim = Simulation(z=6, n=8, pad_to=8, device="cpu")
    v = port_sim._status_pack(sim.state)
    assert v.dtype == torch.int32 and v.shape == (17,)
    assert v[:3].tolist() == [6, 8, 14]
    assert float(v[13:].view(torch.float32)[0]) == float(sim.state.half_life[0])
    ens = Simulation(z=6, n=8, pad_to=8, ensemble=3, device="cpu")
    agg = port_sim._status_pack_batched(ens.state)
    assert agg.dtype == torch.int32 and agg.tolist() == [42] + [0] * 8


# --- throughput, the queue and the guard ----------------------------------------

def test_throughput_observability_and_the_queue():
    sim = Simulation(z=2, n=2, pad_to=8, device="cpu")
    assert sim.fps == 0.0
    for i in range(8):
        sim.frame()
        assert len(sim._inflight) == min(i + 1, 3)  # 4 deep, one retired per frame
    s = sim.status()
    assert s["fps"] > 0 and s["substeps_per_sec"] > 0
    assert s["substeps_per_sec"] == pytest.approx(s["fps"] * sim.substeps_used, rel=0.5)
    sim.reset()
    assert len(sim._inflight) == 0 and sim.fps == 0.0


def test_nan_flag_slots_are_taken_in_turn_whatever_the_frame_count():
    """The pinned slot of a frame's NaN flag comes from a count of the
    markers dispatched: a fused run raises ``frame_count`` by k and
    dispatches none, so slots picked by ``frame_count`` could meet."""
    sim = Simulation(z=2, n=2, pad_to=8, device="cpu")
    slots = sim._inflight.maxlen + 1
    held = []  # the slots of the markers a queue of maxlen - 1 would hold
    for step in range(3 * slots):
        if step in (4, 9):
            sim.run(2, fused=True)  # moves frame_count, takes no slot
            sim.run(slots, fused=True)
        held = (held + [sim._next_nan_slot()])[-sim._inflight.maxlen:]
        assert len(set(held)) == len(held), (step, held)
        assert held[-1] == step % slots
    assert sim._markers_dispatched == 3 * slots and sim.frame_count == 2 * (2 + slots)
    assert sim._nan_slots is None  # no pinned memory on the CPU


def test_nan_guard_reads_the_oldest_frame_at_its_cadence(caplog):
    sim = Simulation(z=2, n=2, pad_to=8, device="cpu")
    sim.nan_check_interval = 3
    pos = sim.state.pos.clone()
    pos[0, 0, 0] = float("nan")
    sim.state = sim.state.replace(pos=pos)
    with caplog.at_level("ERROR", logger="pyqmd_tpu_torch"):
        for _ in range(2):
            sim.frame()
        assert "non-finite" not in caplog.text
        sim.frame()
    assert "non-finite state detected near frame 3" in caplog.text
    caplog.clear()
    quiet = Simulation(z=2, n=2, pad_to=8, device="cpu")
    quiet.nan_check_interval = 1
    with caplog.at_level("ERROR", logger="pyqmd_tpu_torch"):
        quiet.frame()
    assert caplog.text == ""


def test_chain_drain_cadence_prevents_ring_loss():
    jsim, sim = _pair(2, 2, 8)
    cap = sim.cfg.max_chain_log
    assert cap == jsim.cfg.max_chain_log == 256
    drains = {id(jsim): [], id(sim): []}
    for s in (jsim, sim):
        orig = s._drain_chain_log

        def spy(s=s, orig=orig):
            drains[id(s)].append(s.frame_count)
            orig()

        s._drain_chain_log = spy
        s.set_preset("billion")
        for _ in range(30):
            s.frame()
    assert drains[id(sim)] and drains[id(sim)] == drains[id(jsim)]
    gaps = [b - a for a, b in zip([0] + drains[id(sim)], drains[id(sim)])]
    assert all(g <= cap // sim.max_substeps + 1 for g in gaps)
    for s in (jsim, sim):
        s.auto_adjust_substeps = True
        drains[id(s)].clear()
        for _ in range(6):
            s.frame()
    assert sim.substeps_used == jsim.substeps_used > sim.max_substeps
    assert drains[id(sim)] == drains[id(jsim)]
    assert drains[id(sim)][0] - 30 <= cap // sim.substeps_used + 1


def test_a_wrapped_ring_warns_of_lost_entries(caplog):
    sim = Simulation(z=92, n=146, pad_to=128, device="cpu", overrides={"max_chain_log": 4})
    from pyqmd_tpu_torch.core.decay import force_decay
    from pyqmd_tpu_torch.core.dynamics import FrameDynamics
    from pyqmd_tpu_torch import prng

    dyn = FrameDynamics(*(np.float32(x) for x in (1.0, 1.0, 1 / 240, 1 / 240, 1 / 240)))
    for i in range(7):  # decays the simulation's log has not seen
        sim.state, _ = force_decay(sim.state, sim.cfg, prng.fold_in(sim.state.rng, i), dyn)
    with caplog.at_level("WARNING", logger="pyqmd_tpu_torch"):
        log = sim.decay_log
    assert "3 entries lost" in caplog.text and len(log) == 4
    assert [e["index"] for e in sim.chain_entries()] == [4, 5, 6, 7]


# --- controls ------------------------------------------------------------------

def test_presets_keymap_and_limits_equal_the_reference():
    assert TIME_SCALE_PRESETS == jax_sim.TIME_SCALE_PRESETS
    assert ISOTOPE_KEYMAP == jax_sim.ISOTOPE_KEYMAP
    for name in ("MIN_TIME_SCALE", "MAX_TIME_SCALE", "MIN_ZOOM", "MAX_ZOOM"):
        assert getattr(port_sim, name) == getattr(jax_sim, name)


def test_time_and_camera_controls_equal_the_reference():
    jsim, sim = _pair(6, 8, 8)
    for s in (jsim, sim):
        s.frame()
        assert s.substeps_used == 4
        s.set_preset("billion")
        s.frame()
        assert s.substeps_used == 20
        s.scale_time(10.0)
        s.scale_time(1e40)
        s.zoom_by(1e9)
        s.pan(1.0, -1.0)
        for _ in range(5):
            s._lerp_camera()
        s.zoom_by(1e-9)
        s.scale_time(1e-80)
    assert sim.time_scale == jsim.time_scale == 1e-40
    assert sim.target_zoom == jsim.target_zoom == 0.1
    assert sim.camera == jsim.camera and sim.camera_target == jsim.camera_target
    assert sim.zoom == jsim.zoom
    with pytest.raises(KeyError):
        sim.set_preset("warp")


def test_isotope_keymap_and_overrides_survive_reset():
    sim = Simulation(z=92, n=146, seed=0, pad_to=8, device="cpu",
                     overrides={"strong_strength": 99.0})
    sim.set_isotope_key(3)
    assert sim.isotope == "C-14" and sim.cfg.strong_strength == 99.0
    sim.set_isotope_key(42)  # not a key: nothing happens
    assert sim.isotope == "C-14"
    sim.reset(2, 2)
    assert sim.cfg.strong_strength == 99.0 and sim.cfg.z == 2
    sim.frame()
    assert torch.isfinite(sim.state.pos).all()
    sim.reset(seed=5)
    assert sim.seed == 5 and sim.frame_count == 1 and sim.last_metrics is None
