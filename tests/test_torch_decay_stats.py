"""The port's decay-statistics path against the JAX package's: the packed
nucleon bitfields, the stats-only substep, and ``decay_ensemble_step`` over
several frames, both against the reference's jnp bitfield path and its
Pallas kernel in interpret mode.

Integer fields, RNG streams and **alive and ptype** (with alpha emitters,
whose two-nucleon removal the reference's own tests leave unpinned) are
bitwise; half_life, last_decay_time and chain_time agree to 1e-6 relative
(exp and log round differently between libraries). The cases are ones
where no decay draw sits within ULPs of its probability.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from pyqmd_tpu.config import SimConfig as JaxConfig
from pyqmd_tpu.core import decay as jax_decay
from pyqmd_tpu.core.dynamics import FrameDynamics as JaxDynamics
from pyqmd_tpu.core.init import ensemble_init as jax_ensemble_init
from pyqmd_tpu.core.init import mixed_ensemble_init as jax_mixed_init
from pyqmd_tpu.core.step import decay_ensemble_step as jax_decay_step
from pyqmd_tpu.kernels import decay_pallas
from pyqmd_tpu_torch import prng
from pyqmd_tpu_torch.core import decay, step
from pyqmd_tpu_torch.core.dynamics import FrameDynamics
from pyqmd_tpu_torch.kernels.decay import DECAY_FIELDS, _plain_substep, decay_stats_frame
from pyqmd_tpu_torch.state import state_to_numpy
from pyqmd_tpu_torch.utils import profiling

TRAJECTORY = ("z", "n", "decay_counts", "chain_z0", "chain_n0", "chain_dtype", "chain_z1",
              "chain_n1", "chain_cursor", "rng", "alive", "ptype")
FLOATS = ("half_life", "last_decay_time", "chain_time")


def _assert_trajectories_equal(ref: dict, got: dict, fields=TRAJECTORY):
    for f in fields:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    for f in FLOATS:
        tp.assert_rel_close(got[f], ref[f], 1e-6, f)


@pytest.mark.parametrize("p", [8, 16, 100, 256])
def test_bitfield_helpers_match_the_reference(p):
    rng = np.random.default_rng(p)
    b = 32
    alive = rng.uniform(size=(b, p)) < 0.7
    alive[:3] = False  # empty fields: no set bit anywhere
    ptype = rng.integers(0, 2, (b, p)).astype(np.int32)
    jab, jpb = jax_decay.pack_nucleon_bits(jnp.asarray(alive), jnp.asarray(ptype))
    ab, pb = decay.pack_nucleon_bits(torch.from_numpy(alive), torch.from_numpy(ptype))
    np.testing.assert_array_equal(ab.numpy(), np.asarray(jab).astype(np.int64))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jpb).astype(np.int64))

    ja, jp = jax_decay.unpack_alive_ptype(jab, jpb, p)
    a, t = decay.unpack_alive_ptype(ab, pb, p)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(a.numpy(), alive)

    r = rng.integers(0, 3, b).astype(np.int32)
    for x, jx in ((ab & pb, jab & jpb), (ab & ~pb, jab & ~jpb)):
        want = jax.vmap(jax_decay._lowest_set_bits)(jx, jnp.asarray(r))
        got = decay._lowest_set_bits(x, torch.from_numpy(r))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
        want = jax.vmap(jax_decay._first_set_bit)(jx)
        np.testing.assert_array_equal(decay._first_set_bit(x).numpy(),
                                      np.asarray(want).astype(np.int64))


def test_stats_draws_are_the_first_of_the_full_draw():
    keys = torch.from_numpy(np.random.default_rng(0).integers(0, 2**32, (257, 2), dtype=np.int64))
    cfg = tp.port_cfg(JaxConfig())
    full = prng.uniform(keys, (1 + decay._decay_draw_count(cfg),))
    assert full.shape[1] == 11
    assert torch.equal(prng.uniform(keys, (decay.STATS_DRAWS,)), full[:, :decay.STATS_DRAWS])


@pytest.mark.parametrize("zn,pad_to,step_time", [
    ((6, 8), 8, 1e11),       # β-, one word
    ((82, 132), 8, 1e3),     # β- into β-
    ((92, 146), 128, 1e17),  # α, eight words
])
def test_stats_substep_matches_the_reference(zn, pad_to, step_time):
    cfg = JaxConfig.for_isotope(*zn, pad_to=pad_to)
    b = 64
    jst = jax_ensemble_init(cfg, b, seed=1)
    pst = tp.to_port(jst)
    jd = JaxDynamics(jnp.float32(1.0), jnp.float32(1.0), jnp.float32(cfg.effective_dt()),
                     jnp.float32(step_time), None)
    pd = FrameDynamics(np.float32(1.0), np.float32(1.0), np.float32(cfg.effective_dt()),
                       np.float32(step_time), None)
    jbits = jax_decay.pack_nucleon_bits(jst.alive, jst.ptype)
    bits = decay.pack_nucleon_bits(pst.alive, pst.ptype)
    fired = 0
    for s in range(3):
        jkeys = jax.random.split(jax.random.PRNGKey(10 + s), b)
        keys = torch.from_numpy(np.asarray(jax.random.key_data(jkeys)).astype(np.int64))
        jst, jtype, jbits = jax.vmap(
            lambda st, a, pb, k: jax_decay.maybe_decay(
                st, cfg, k, jd, row_tables=True, stats_only=True, packed_nucleons=(a, pb))
        )(jst, jbits[0], jbits[1], jkeys)
        pst, ptype, bits = decay.maybe_decay(pst, tp.port_cfg(cfg), keys, pd, stats_only=True,
                                             packed_nucleons=bits)
        np.testing.assert_array_equal(ptype.numpy(), np.asarray(jtype))
        for g, w in zip(bits, jbits):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
        _assert_trajectories_equal(tp.jax_to_numpy(jst), state_to_numpy(pst),
                                   [f for f in TRAJECTORY if f not in ("alive", "ptype")])
        fired += int((np.asarray(jtype) != 0).sum())
    assert fired > 10


@pytest.mark.parametrize("zn,pad_to,step_time", [
    ((6, 8), 8, 1e11),
    ((82, 132), 8, 1e3),
    ((92, 146), 128, 1e17),
])
def test_stats_rank_mask_form_matches_the_reference(zn, pad_to, step_time):
    """``stats_only`` without bitfields updates alive/ptype as (B, P) masks:
    bitwise the reference's, the packed form's after unpacking, and with
    positions, velocities and ejecta left as they were."""
    cfg = JaxConfig.for_isotope(*zn, pad_to=pad_to)
    pcfg = tp.port_cfg(cfg)
    b = 64
    jst = jax_ensemble_init(cfg, b, seed=3)
    pst = tp.to_port(jst)
    jd = JaxDynamics(jnp.float32(1.0), jnp.float32(1.0), jnp.float32(cfg.effective_dt()),
                     jnp.float32(step_time), None)
    pd = FrameDynamics(np.float32(1.0), np.float32(1.0), np.float32(cfg.effective_dt()),
                       np.float32(step_time), None)
    fired = 0
    for s in range(3):
        jkeys = jax.random.split(jax.random.PRNGKey(20 + s), b)
        keys = torch.from_numpy(np.asarray(jax.random.key_data(jkeys)).astype(np.int64))
        jst, jtype = jax.vmap(
            lambda st, k: jax_decay.maybe_decay(st, cfg, k, jd, row_tables=True, stats_only=True)
        )(jst, jkeys)
        packed, _, bits = decay.maybe_decay(pst, pcfg, keys, pd, stats_only=True,
                                            packed_nucleons=decay.pack_nucleon_bits(pst.alive,
                                                                                    pst.ptype))
        new, ptype = decay.maybe_decay(pst, pcfg, keys, pd, stats_only=True)
        np.testing.assert_array_equal(ptype.numpy(), np.asarray(jtype))
        _assert_trajectories_equal(tp.jax_to_numpy(jst), state_to_numpy(new))
        alive, types = decay.unpack_alive_ptype(*bits, pcfg.max_particles)
        assert torch.equal(new.alive, alive) and torch.equal(new.ptype, types)
        for f in DECAY_FIELDS:
            assert torch.equal(getattr(new, f), getattr(packed, f)), f
        for f in ("pos", "vel", "ej_pos", "ej_alive", "ej_cursor"):
            assert torch.equal(getattr(new, f), getattr(pst, f)), f
        pst = new
        fired += int((np.asarray(jtype) != 0).sum())
    assert fired > 10


def test_wrapper_updates_the_carry_in_place_on_cpu():
    cfg = JaxConfig.for_isotope(82, 132, pad_to=8)
    st = tp.to_port(jax_ensemble_init(cfg, 16, seed=2))
    pcfg = tp.port_cfg(cfg)
    dyn = FrameDynamics(np.float32(1.0), np.float32(1.0), np.float32(cfg.effective_dt()),
                        np.float32(2e3), None)
    keys = prng.split(prng.prng_key(4, device="cpu"), 16)
    bits = decay.pack_nucleon_bits(st.alive, st.ptype)
    want, _, want_bits = decay.maybe_decay(st, pcfg, keys, dyn, stats_only=True,
                                           packed_nucleons=bits)
    carry = st.replace(**{f: getattr(st, f).clone() for f in DECAY_FIELDS})
    carry_bits = tuple(x.clone() for x in bits)
    ptrs = [getattr(carry, f).data_ptr() for f in DECAY_FIELDS]
    before = profiling.counters()
    _plain_substep(carry, carry_bits, pcfg, keys, dyn)
    assert profiling.counters() == before  # no kernel ran
    assert ptrs == [getattr(carry, f).data_ptr() for f in DECAY_FIELDS]
    for f in DECAY_FIELDS:
        assert torch.equal(getattr(carry, f), getattr(want, f)), f
    assert all(torch.equal(a, b) for a, b in zip(carry_bits, want_bits))
    assert int((want.chain_cursor != st.chain_cursor).sum()) > 0


def _frame_case(name):
    """(jax config, jax initial state, time scale, frame_dt)."""
    if name == "c14":
        cfg = JaxConfig.for_isotope(6, 8, pad_to=8)
        return cfg, jax_ensemble_init(cfg, 64, seed=0), 3.15576e10, 1.0
    if name == "pb214":
        cfg = JaxConfig.for_isotope(82, 132, pad_to=8)
        return cfg, jax_ensemble_init(cfg, 48, seed=0), 400.0, 1.0
    if name == "u238":
        cfg = JaxConfig.for_isotope(92, 146, pad_to=128)
        return cfg, jax_ensemble_init(cfg, 8, seed=0), 3.15576e18, 1 / 60
    cfg = JaxConfig.for_isotope(92, 146, pad_to=8)
    return cfg, jax_mixed_init(cfg, [(92, 146, 6), (6, 8, 10)], seed=0), 3.15576e18, 1 / 60


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("case", ["c14", "pb214", "u238", "mixed"])
def test_decay_frames_match_the_reference(monkeypatch, case, backend):
    cfg, jst, ts, frame_dt = _frame_case(case)
    if backend == "pallas_interpret":
        monkeypatch.setattr(decay_pallas, "decay_stats_substep_t",
                            functools.partial(decay_pallas.decay_stats_substep_t,
                                              interpret=True))
        cfg = dataclasses.replace(cfg, decay_backend="pallas")
    assert (cfg.decay_backend == "pallas") == (backend == "pallas_interpret")
    pst = tp.to_port(jst)
    jfn = jax.jit(lambda s: jax_decay_step(s, cfg, ts, frame_dt, 4))
    pfn = step.make_decay_frame_fn(tp.port_cfg(cfg), 4)
    for _ in range(3):
        jst, jm = jfn(jst)
        pst, pm = pfn(pst, ts, frame_dt)
        _assert_trajectories_equal(tp.jax_to_numpy(jst), state_to_numpy(pst))
        for k in ("alive", "z", "n", "decay_counts", "chain_cursor", "total_decay_counts",
                  "total_alive"):
            np.testing.assert_array_equal(pm[k].numpy(), np.asarray(jm[k]), err_msg=k)
    counts = np.asarray(jm["total_decay_counts"])
    assert counts.sum() > 5
    if case in ("u238", "mixed"):
        assert counts[1] > 0  # alpha decays: two-nucleon removals pinned


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("case", ["c14", "pb214", "u238", "mixed"])
def test_frame_wrapper_on_cpu_is_the_reference_frame(monkeypatch, case, backend):
    """``decay_stats_frame`` on CPU tensors, called as the port's frame
    calls it (clock advanced, carry cloned, nucleons packed), against the
    JAX package's ``decay_ensemble_step``: its next rng and the carry's
    fields, alive and ptype bitwise; the caller's rng is only read."""
    cfg, jst, ts, frame_dt = _frame_case(case)
    if backend == "pallas_interpret":
        monkeypatch.setattr(decay_pallas, "decay_stats_substep_t",
                            functools.partial(decay_pallas.decay_stats_substep_t,
                                              interpret=True))
        cfg = dataclasses.replace(cfg, decay_backend="pallas")
    pcfg = tp.port_cfg(cfg)
    pst = tp.to_port(jst)
    rng_before = pst.rng.clone()
    ref, _ = jax.jit(lambda s: jax_decay_step(s, cfg, ts, frame_dt, 5))(jst)
    adv, dyn = step._frame_clock(pst, pcfg, ts, frame_dt, 5, None, None)
    carry = adv.replace(**{f: getattr(adv, f).clone() for f in DECAY_FIELDS})
    bits = decay.pack_nucleon_bits(adv.alive, adv.ptype)
    before = profiling.counters()["kernels.decay_stats_frame.launches"]
    rng = decay_stats_frame(carry, bits, adv.rng, pcfg, dyn, 5)
    # the plain version ran
    assert profiling.counters()["kernels.decay_stats_frame.launches"] == before
    assert torch.equal(pst.rng, rng_before) and not torch.equal(rng, rng_before)
    alive, ptype = decay.unpack_alive_ptype(*bits, pcfg.max_particles)
    got = carry.replace(alive=alive, ptype=ptype, rng=rng)
    _assert_trajectories_equal(tp.jax_to_numpy(ref), state_to_numpy(got))
    assert int(np.asarray(ref.decay_counts).sum()) > 0


def test_decay_frame_walks_the_full_frame_trajectories():
    """The port's decay-only frame and its full-physics frame, same seed:
    the same isotope trajectories, alive and ptype bitwise (the reference's
    tests/test_batch_native.py invariant, with the nucleon masks too)."""
    cfg = tp.port_cfg(JaxConfig.for_isotope(82, 132, pad_to=8))
    full = tp.to_port(jax_ensemble_init(JaxConfig.for_isotope(82, 132, pad_to=8), 48, seed=0))
    fast = full
    f_full = step.make_frame_fn(cfg, 6, batched=True)
    f_fast = step.make_decay_frame_fn(cfg, 6)
    for _ in range(5):
        full, mf = f_full(full, 400.0, 1.0)
        fast, md = f_fast(fast, 400.0, 1.0)
    assert int(mf["total_decay_counts"].sum()) > 10
    for k in ("z", "n", "half_life", "decay_counts", "chain_cursor", "time_passed", "alive"):
        assert torch.equal(mf[k], md[k]), k
    for f in ("chain_z0", "chain_n0", "chain_dtype", "chain_z1", "chain_n1", "chain_time",
              "rng", "alive", "ptype", "last_decay_time"):
        assert torch.equal(getattr(full, f), getattr(fast, f)), f


def test_decay_frame_counts_survive_beyond_uint16():
    """Per-nucleus decay counts are unbounded on self-looping chains
    (Tc-99m), so the carry keeps them int32."""
    cfg = tp.port_cfg(JaxConfig.for_isotope(2, 2, pad_to=8))
    states = tp.to_port(jax_ensemble_init(JaxConfig.for_isotope(2, 2, pad_to=8), 8, seed=0))
    states = states.replace(decay_counts=torch.full_like(states.decay_counts, 70000))
    before = states.decay_counts.clone()
    states2, m = step.make_decay_frame_fn(cfg, 4)(states, 1.0e6, 1.0)
    assert (states2.decay_counts == 70000).all() and (m["decay_counts"] == 70000).all()
    assert torch.equal(states.decay_counts, before)  # the caller's state is not written
