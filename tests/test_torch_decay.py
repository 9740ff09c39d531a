"""The port's batched decay substep against the JAX package's
``vmap(maybe_decay_from_u(..., row_tables=True))`` on the same uniforms.

Parents cover every decay mode: α (U-238), β- (C-14), β+ and proton
emission (predicted modes), γ / β- branching (Tc-99m), and neutron emission
and fission through two table cells patched in both packages (no tabulated
or predicted isotope emits those). The Bernoulli draw is forced both ways
(u[0] = 0 fires for every p > 0, u[0] = 0.999 fires for none), so no
decision sits within ULPs of p. Integer fields are bitwise; floats agree to
1e-6 relative (the CoM and exp/log/cos/sin round differently between
libraries).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from pyqmd_tpu.config import SimConfig as JaxConfig
from pyqmd_tpu.core.decay import maybe_decay_from_u as jax_maybe_decay_from_u
from pyqmd_tpu.core.dynamics import FrameDynamics as JaxDynamics
from pyqmd_tpu.core.init import mixed_ensemble_init
from pyqmd_tpu.data import tables as jax_tables
from pyqmd_tpu.state import DECAY_NEUTRON_EMISSION, DECAY_SPONTANEOUS_FISSION
from pyqmd_tpu.state import NucleusState as JaxState
from pyqmd_tpu_torch.core import decay
from pyqmd_tpu_torch.core.dynamics import FrameDynamics
from pyqmd_tpu_torch.data import tables
from pyqmd_tpu_torch.state import state_from_numpy, state_to_numpy

FLOAT_FIELDS = ("pos", "vel", "half_life", "ej_pos", "ej_vel", "ej_age", "ej_life",
                "time_passed", "last_decay_time", "chain_time")

# (Z, N) of each parent and its decay mode.
PARENTS = [
    (92, 146),  # α
    (6, 8),     # β-
    (40, 50),   # β+ (predicted)
    (25, 20),   # proton emission (predicted)
    (43, 56),   # γ 0.99 / β- 0.01 (Tc-99m)
    (60, 100),  # fission (patched cell)
    (10, 20),   # neutron emission (patched cell)
    (2, 2),     # stable
]


@pytest.fixture
def patched_tables(monkeypatch):
    """Fission and neutron-emission cells, patched into both packages."""
    rows = jax_tables._ROWS.copy()
    for (z, n), (z1, n1, mode) in {
        (60, 100): (30, 50, DECAY_SPONTANEOUS_FISSION),
        (10, 20): (10, 19, DECAY_NEUTRON_EMISSION),
    }.items():
        i = z * jax_tables.N_DIM + n
        rows[i, 5] = 1.0
        rows[i, 6:12] = (z1, n1, mode, z1, n1, mode)
        rows[i, 0] = 1e3  # a tabulated half-life: the cell decays
    monkeypatch.setattr(jax_tables, "_ROWS", rows)
    monkeypatch.setattr(tables, "_ROWS", rows)


def _dynamics(ts, ss, step_time, cfg):
    jd = JaxDynamics(
        time_scale=jnp.float32(ts), substeps=jnp.float32(ss),
        physics_dt=jnp.float32(cfg.effective_dt()), step_time=jnp.float32(step_time),
        raw_physics_dt=jnp.float32(cfg.physics_dt),
    )
    pd = FrameDynamics(
        time_scale=np.float32(ts), substeps=np.float32(ss),
        physics_dt=np.float32(cfg.effective_dt()), step_time=np.float32(step_time),
        raw_physics_dt=np.float32(cfg.physics_dt),
    )
    return jd, pd


def _initial_state(cfg, per_parent, seed):
    """A mixed ensemble with rings part-full and cursors near wrap-around,
    and clocks that exercise both the measured and synthetic durations."""
    st = mixed_ensemble_init(cfg, [(z, n, per_parent) for z, n in PARENTS], seed=seed)
    b = st.z.shape[0]
    rng = np.random.default_rng(seed)
    ref = {k: np.array(v) for k, v in tp.jax_to_numpy(st).items()}
    ref["chain_cursor"] = rng.integers(1, 3 * cfg.max_chain_log, b).astype(np.int32)
    ref["ej_cursor"] = rng.integers(0, 3 * cfg.max_ejecta, b).astype(np.int32)
    ref["vel"] = rng.normal(0, 2, ref["vel"].shape).astype(np.float32)
    ref["time_passed"] = rng.choice([0.0, 5e-4, 50.0, 3e9], b).astype(np.float32)
    ref["last_decay_time"] = np.where(rng.uniform(size=b) < 0.5, 0.0,
                                      ref["time_passed"]).astype(np.float32)
    return ref


@pytest.mark.parametrize("ts,ss", [(3.0e10, 20.0), (0.5, 3.0)])
def test_decay_substeps_match_the_reference(patched_tables, ts, ss):
    cfg = JaxConfig(z=92, n=146, max_particles=256, max_ejecta=8, max_chain_log=8)
    pcfg = tp.port_cfg(cfg)
    jd, pd = _dynamics(ts, ss, 1e10, cfg)
    ref = _initial_state(cfg, per_parent=4, seed=1)
    b = ref["z"].shape[0]
    jst = JaxState(**{k: jnp.asarray(v) for k, v in ref.items()})
    pst = state_from_numpy(ref, device="cpu")
    rng = np.random.default_rng(2)
    fired = 0
    for step in range(4):
        u = rng.uniform(size=(b, 1 + 4 + 2 * cfg.max_ejecta_per_event)).astype(np.float32)
        u[:, 0] = np.where(np.arange(b) % 2 == step % 2, 0.0, 0.999)
        jst, jtype = jax.vmap(
            lambda s, uu: jax_maybe_decay_from_u(s, cfg, uu, jd, row_tables=True)
        )(jst, jnp.asarray(u))
        pst, ptype = decay.maybe_decay_from_u(pst, pcfg, torch.from_numpy(u), pd)
        np.testing.assert_array_equal(ptype.numpy(), np.asarray(jtype))
        fired += int((np.asarray(jtype) != 0).sum())
        want = tp.jax_to_numpy(jst)
        tp.assert_fields_equal(want, pst, tp.INT_FIELDS)
        got = state_to_numpy(pst)
        for f in FLOAT_FIELDS:
            tp.assert_rel_close(got[f], want[f], 1e-6, f)
    modes = set(np.asarray(jst.chain_dtype).ravel().tolist())
    assert {1, 2, 3, 4, 5, 6, 7} <= modes, modes
    assert fired > b


def test_decay_probability_matches_the_reference():
    from pyqmd_tpu.core.decay import decay_probability as jax_p

    hl = np.array([np.inf, 1e-40, 1e-3, 1.0, 5.0, 1e3, 1.41e17, 3e30], np.float32)
    for dt in (1e-6, 0.01, 1.0, 1e10, 1.75e16):
        ref = np.asarray(jax_p(jnp.asarray(hl), jnp.float32(dt)))
        got = decay.decay_probability(torch.from_numpy(hl), np.float32(dt)).numpy()
        tp.assert_rel_close(got, ref, 1e-6, str(dt))


def test_ejecta_lifetime_matches_the_reference():
    from pyqmd_tpu.core.decay import ejecta_lifetime as jax_life

    cfg = JaxConfig()
    types = np.arange(6, dtype=np.int32)
    for ts, ss in ((0.5, 3.0), (1.0, 20.0), (3e10, 4.0), (3e10, 20.0), (150.0, 16.0)):
        jd, pd = _dynamics(ts, ss, 1.0, cfg)
        ref = np.asarray(jax_life(jnp.asarray(types), jd, cfg))
        got = decay.ejecta_lifetime(torch.from_numpy(types), pd, tp.port_cfg(cfg)).numpy()
        np.testing.assert_array_equal(got, ref)


def test_rank_masks_match_the_reference():
    from pyqmd_tpu.core.decay import _first_rank_masks as jax_ranks
    from pyqmd_tpu.state import empty_state as jax_empty

    rng = np.random.default_rng(4)
    alive = rng.uniform(size=(5, 16)) < 0.7
    ptype = rng.integers(0, 2, (5, 16)).astype(np.int32)
    cfg = JaxConfig(z=2, n=2, max_particles=16)
    for i in range(5):
        st = dataclasses.replace(jax_empty(cfg), alive=jnp.asarray(alive[i]),
                                 ptype=jnp.asarray(ptype[i]))
        ref = jax_ranks(st)
        got = decay._first_rank_masks(torch.from_numpy(alive[i:i + 1]),
                                      torch.from_numpy(ptype[i:i + 1]))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy()[0], np.asarray(r))


def test_force_decay_matches_the_reference():
    """``force_decay`` (every nucleus fires) over ``apply_decay``'s own
    draws, against the reference's per-nucleus form under ``vmap``."""
    from pyqmd_tpu.core.decay import force_decay as jax_force_decay

    cfg = JaxConfig(z=92, n=146, max_particles=256, max_ejecta=8, max_chain_log=8)
    jd, pd = _dynamics(3.0e10, 20.0, 1e10, cfg)
    ref = _initial_state(cfg, per_parent=3, seed=3)
    b = ref["z"].shape[0]
    jkeys = jax.random.split(jax.random.PRNGKey(5), b)
    keys = torch.from_numpy(np.asarray(jax.random.key_data(jkeys)).astype(np.int64))
    jst, jtype = jax.vmap(lambda s, k: jax_force_decay(s, cfg, k, jd))(
        JaxState(**{k: jnp.asarray(v) for k, v in ref.items()}), jkeys
    )
    pst, ptype = decay.force_decay(state_from_numpy(ref, device="cpu"), tp.port_cfg(cfg), keys, pd)
    np.testing.assert_array_equal(ptype.numpy(), np.asarray(jtype))
    want = tp.jax_to_numpy(jst)
    tp.assert_fields_equal(want, pst, tp.INT_FIELDS)
    got = state_to_numpy(pst)
    for f in FLOAT_FIELDS:
        tp.assert_rel_close(got[f], want[f], 1e-6, f)
    assert int((ptype != 0).sum()) >= 6 * 3  # every decaying parent fired
