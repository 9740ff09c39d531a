"""The slice as a whole: the port's batched frame against the JAX package's
``make_frame_fn(cfg, S, batched=True)`` (jnp force backend) from the same
initial state.

Integer fields, RNG streams and integer metrics are bitwise: decay
decisions depend only on the draws and the half-lives, not on positions.
Positions and velocities agree within 1e-3 after one frame (the dynamics
are chaotic, so the comparison stops there); half-lives and chain times to
1e-6 relative (exp/log round differently between libraries). The cases are
ones where no decay draw sits within ULPs of its probability.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from pyqmd_tpu.config import SimConfig as JaxConfig
from pyqmd_tpu.core.dynamics import FrameDynamics as JaxDynamics
from pyqmd_tpu.core.init import ensemble_init as jax_ensemble_init
from pyqmd_tpu.core.step import advance_ejecta as jax_advance_ejecta
from pyqmd_tpu.core.step import make_frame_fn as jax_make_frame_fn
from pyqmd_tpu.state import NucleusState as JaxState
from pyqmd_tpu_torch.core import decay, step
from pyqmd_tpu_torch.core.dynamics import FrameDynamics
from pyqmd_tpu_torch.core.init import ensemble_init
from pyqmd_tpu_torch.state import NucleusState, state_from_numpy, state_to_numpy

INT_METRICS = ("nan", "alive", "z", "n", "decay_counts", "chain_cursor",
               "total_decay_counts", "total_alive")
FLOAT_METRICS = ("kinetic", "half_life", "time_passed", "com", "rms_radius")


def _compare_frame(ref_st, ref_m, got_st, got_m, floats: bool):
    ref = tp.jax_to_numpy(ref_st)
    tp.assert_fields_equal(ref, got_st, tp.INT_FIELDS)
    assert set(got_m) == set(ref_m)
    for k in INT_METRICS:
        np.testing.assert_array_equal(got_m[k].numpy(), np.asarray(ref_m[k]), err_msg=k)
    got = state_to_numpy(got_st)
    tp.assert_rel_close(got["half_life"], ref["half_life"], 1e-6, "half_life")
    tp.assert_rel_close(got["chain_time"], ref["chain_time"], 1e-6, "chain_time")
    if floats:
        for f in ("pos", "vel", "ej_pos"):
            np.testing.assert_allclose(got[f], ref[f], rtol=1e-3, atol=1e-3, err_msg=f)
        np.testing.assert_array_equal(got["time_passed"], ref["time_passed"])
        for k in FLOAT_METRICS:
            np.testing.assert_allclose(got_m[k].numpy(), np.asarray(ref_m[k]), rtol=1e-3,
                                       atol=1e-3, err_msg=k)


@pytest.mark.parametrize("zn,pad_to,batch,steps,ts,seed", [
    ((92, 146), 128, 4, 3, 3.15576e18, 0),
    ((6, 8), 8, 16, 3, 3.15576e13, 0),
    ((2, 2), 8, 16, 3, 3.15576e13, 2),
])
def test_frames_match_the_reference(zn, pad_to, batch, steps, ts, seed):
    cfg = JaxConfig.for_isotope(*zn, pad_to=pad_to)
    jst = jax_ensemble_init(cfg, batch, seed=seed)
    pst = tp.to_port(jst)
    jfn = jax_make_frame_fn(cfg, steps, batched=True)
    pfn = step.make_frame_fn(tp.port_cfg(cfg), steps, batched=True)
    fired = 0
    for frame in range(2):
        jst, jm = jfn(jst, ts, 1 / 60)
        pst, pm = pfn(pst, ts, 1 / 60)
        _compare_frame(jst, jm, pst, pm, floats=frame == 0)
        fired = int(np.asarray(jm["total_decay_counts"]).sum())
    if zn != (2, 2):
        assert fired > 0
    assert not bool(pm["nan"].any())


def _member(st: NucleusState, b: int) -> NucleusState:
    return NucleusState(**{f.name: getattr(st, f.name)[b:b + 1]
                           for f in dataclasses.fields(st)})


def test_ensemble_step_equals_per_member_simulate_frame():
    """The reference invariant of tests/test_batch_native.py: a batched
    frame equals each member's single-nucleus frame bitwise."""
    cfg = tp.port_cfg(JaxConfig.for_isotope(6, 8, pad_to=8))
    states = tp.to_port(jax_ensemble_init(JaxConfig.for_isotope(6, 8, pad_to=8), 16, seed=0))
    batched, bm = step.ensemble_step(states, cfg, 3.0e10, 1.0, 3)
    assert int(bm["total_decay_counts"].sum()) > 0
    for b in range(16):
        single, sm = step.simulate_frame(_member(states, b), cfg, 3.0e10, 1.0, 3)
        assert set(sm) == set(step.METRIC_KEYS)
        for f in dataclasses.fields(single):
            torch.testing.assert_close(getattr(single, f.name), getattr(batched, f.name)[b:b + 1],
                                       rtol=0, atol=0, equal_nan=True, msg=f.name)
        for k in step.METRIC_KEYS:
            torch.testing.assert_close(sm[k], bm[k][b:b + 1], rtol=0, atol=0, msg=k)


def test_simulate_frame_takes_a_batch_of_one():
    cfg = tp.port_cfg(JaxConfig.for_isotope(2, 2, pad_to=8))
    with pytest.raises(ValueError):
        step.simulate_frame(ensemble_init(cfg, 2, device="cpu"), cfg, 1.0, 1 / 60, 1)


def test_advance_ejecta_matches_the_reference():
    """Ejecta advection, ageing and expiry in both time-scale regimes."""
    cfg = JaxConfig.for_isotope(2, 2, pad_to=8, max_ejecta=16)
    ref = {k: np.array(v) for k, v in tp.jax_to_numpy(jax_ensemble_init(cfg, 6, seed=0)).items()}
    rng = np.random.default_rng(0)
    ref["ej_type"] = rng.integers(0, 6, (6, 16)).astype(np.int32)
    ref["ej_alive"] = rng.uniform(size=(6, 16)) < 0.7
    ref["ej_vel"] = rng.normal(0, 30, (6, 16, 2)).astype(np.float32)
    ref["ej_pos"] = rng.uniform(300, 500, (6, 16, 2)).astype(np.float32)
    ref["ej_life"] = rng.uniform(0.5, 4.0, (6, 16)).astype(np.float32)
    ref["ej_age"] = rng.uniform(0.0, 4.0, (6, 16)).astype(np.float32)
    jst = JaxState(**{k: jnp.asarray(v) for k, v in ref.items()})
    for ts, ss in ((1.0, 4.0), (3e4, 20.0)):
        step_time = np.float32(np.float32(1 / 60) * np.float32(ts)) / np.float32(ss)
        jd = JaxDynamics(jnp.float32(ts), jnp.float32(ss), jnp.float32(cfg.effective_dt()),
                         jnp.float32(step_time), jnp.float32(cfg.physics_dt))
        pd = FrameDynamics(np.float32(ts), np.float32(ss), np.float32(cfg.effective_dt()),
                           step_time, np.float32(cfg.physics_dt))
        want = tp.jax_to_numpy(jax.vmap(lambda s: jax_advance_ejecta(s, cfg, jd))(jst))
        got = state_to_numpy(decay.advance_ejecta(state_from_numpy(ref, device="cpu"),
                                                  tp.port_cfg(cfg), pd))
        np.testing.assert_array_equal(got["ej_alive"], want["ej_alive"])
        np.testing.assert_array_equal(got["ej_age"], want["ej_age"])
        np.testing.assert_allclose(got["ej_pos"], want["ej_pos"], rtol=1e-6)
