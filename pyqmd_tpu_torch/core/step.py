"""The batched frames: substeps as a Python loop over batched tensor ops.

In the full-physics frame each substep advances the ejecta, runs the decay
check, and calls the force + integrate step; the frame ends with one
overlap projection and the metrics (reference nuclear_sim.py:118-176). The
decay-statistics frame runs only the decay checks, all of a frame's
substeps in one kernel call. The force, overlap and decay passes go through
the kernel wrappers, which take the plain PyTorch version for CPU tensors
and the CUDA kernel for CUDA tensors.

The frame's scalars are computed in f32 in the JAX package's order, and
every draw follows its key tree (``core/step.py:268-289`` there), so
integer fields and RNG streams equal the reference's bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from pyqmd_tpu_torch import prng
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core.decay import maybe_decay, pack_nucleon_bits, unpack_alive_ptype
from pyqmd_tpu_torch.core.dynamics import FrameDynamics
from pyqmd_tpu_torch.core.overlap import _rand_u
from pyqmd_tpu_torch.kernels.decay import DECAY_FIELDS, decay_stats_frame
from pyqmd_tpu_torch.kernels.forces import force_step
from pyqmd_tpu_torch.kernels.overlap import overlap_step
from pyqmd_tpu_torch.state import ALPHA, NucleusState

_F32 = np.float32


def advance_ejecta(state: NucleusState, cfg: SimConfig, dyn: FrameDynamics) -> NucleusState:
    """Ejecta advection + ageing + expiry (nuclear_sim.py:178-210).

    Animated decay products (alpha/e-/gamma/e+) move at a fixed animation
    timestep with substep-compensated speed and age with the reference's
    time-scale-damped rate; emitted nucleons advect with
    ``dt * sqrt(time_scale)`` and never expire.
    """
    is_anim = state.ej_type >= ALPHA
    substep_factor = _F32(10.0) / np.maximum(_F32(1.0), dyn.substeps)
    # The reference folds the two config constants in float64 first.
    anim_step = (cfg.animation_dt * cfg.ejecta_speed_scale) * substep_factor
    nucleon_step = dyn.physics_dt * np.sqrt(dyn.time_scale)
    step = torch.where(is_anim, float(anim_step), float(nucleon_step))

    live = state.ej_alive
    new_pos = state.ej_pos + state.ej_vel * torch.where(live, step, 0.0)[..., None]

    aging_scale = np.minimum(
        _F32(1.0),
        _F32(1.0)
        / (
            np.sqrt(np.maximum(_F32(1.0), dyn.time_scale / _F32(100.0)))
            * np.sqrt(np.maximum(_F32(1.0), dyn.substeps / _F32(10.0)))
        ),
    )
    age_inc = torch.where(
        is_anim, float(dyn.step_time * aging_scale), float(dyn.step_time)
    )
    new_age = state.ej_age + torch.where(live, age_inc, 0.0)
    expired = is_anim & (new_age >= state.ej_life)
    return state.replace(ej_pos=new_pos, ej_age=new_age, ej_alive=live & ~expired)


# Per-nucleus metric keys produced by state_metrics.
METRIC_KEYS = (
    "nan", "alive", "kinetic", "z", "n", "half_life", "decay_counts",
    "time_passed", "com", "chain_cursor", "rms_radius",
)

# Ensemble aggregates. ``survivors`` is added only by the sharded frames of
# :mod:`pyqmd_tpu_torch.parallel`, which sum all three over the data group.
AGGREGATE_METRIC_KEYS = ("total_decay_counts", "total_alive", "survivors")


def state_metrics(state: NucleusState) -> dict:
    """Observable per-nucleus metrics, including the NaN guard that
    surfaces numerical blow-up."""
    return {
        "nan": ~torch.all(
            (torch.isfinite(state.pos) & torch.isfinite(state.vel)).flatten(-2), dim=-1
        ),
        "alive": state.alive_count(),
        "kinetic": state.kinetic_energy(),
        "z": state.z,
        "n": state.n,
        "half_life": state.half_life,
        "decay_counts": state.decay_counts,
        "time_passed": state.time_passed,
        "com": state.center_of_mass(),
        "chain_cursor": state.chain_cursor,
        "rms_radius": state.rms_radius(),
    }


def _ensemble_metrics(states: NucleusState) -> dict:
    """Per-nucleus metrics plus the aggregate decay statistics, summed on
    the device."""
    metrics = state_metrics(states)
    metrics["total_decay_counts"] = metrics["decay_counts"].sum(0, dtype=torch.int32)
    metrics["total_alive"] = metrics["alive"].sum(dtype=torch.int32)
    return metrics


def _batched_overlap(pos, alive, keys, cfg: SimConfig):
    """``cfg.overlap_iterations`` overlap passes over the batch; pass i
    draws its angles from ``fold_in(key, i)`` of each member's key."""
    p = pos.shape[-2]
    for i in range(cfg.overlap_iterations):
        u = _rand_u(prng.fold_in(keys, i), p)
        pos = overlap_step(pos, alive, u, cfg)
    return pos


def _frame_clock(
    states: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt,
    raw_physics_dt,
) -> tuple[NucleusState, FrameDynamics]:
    """Clock advance and :class:`FrameDynamics`, host scalars in f32."""
    time_scale = _F32(time_scale)
    frame_dt = _F32(frame_dt)
    if physics_dt is None:
        physics_dt = cfg.effective_dt()
    desired_dt = frame_dt * time_scale
    # time_passed advances at frame start (nuclear_sim.py:124), so every
    # substep's decay record sees the same frame clock.
    states = states.replace(time_passed=states.time_passed + float(desired_dt))

    dyn = FrameDynamics(
        time_scale=time_scale,
        substeps=_F32(num_steps),
        physics_dt=_F32(physics_dt),
        step_time=desired_dt / _F32(num_steps),
        raw_physics_dt=None if raw_physics_dt is None else _F32(raw_physics_dt),
    )
    return states, dyn


def _batched_frame_preamble(
    states: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt,
    raw_physics_dt,
):
    """:func:`_frame_clock` and the per-nucleus key tree: base key → 3-way
    split (substeps, overlap, next) → per-substep keys."""
    states, dyn = _frame_clock(
        states, cfg, time_scale, frame_dt, num_steps, physics_dt, raw_physics_dt
    )
    k3 = prng.split(states.rng, 3)  # (B, 3, 2)
    step_keys = prng.split(k3[:, 0], num_steps).transpose(0, 1)  # (S, B, 2)
    return states, dyn, k3, step_keys


def _frame_body(
    states: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt=None,
    raw_physics_dt=None,
    force_step_fn=None,
) -> NucleusState:
    """The full-physics frame without its metrics: clock, key tree,
    ``num_steps`` substeps and the overlap projection.

    ``force_step_fn`` replaces the force + integrate step, with the
    signature of :func:`pyqmd_tpu_torch.kernels.forces.force_step`
    ``(pos, vel, ptype, alive, dt, cfg)``; the particle-axis ring of
    :mod:`pyqmd_tpu_torch.parallel.ring` runs through it while the rest of
    the frame stays replicated. ``None`` is the kernel wrapper."""
    fstep = force_step_fn or force_step
    states, dyn, k3, step_keys = _batched_frame_preamble(
        states, cfg, time_scale, frame_dt, num_steps, physics_dt, raw_physics_dt
    )
    for s in range(num_steps):
        states = advance_ejecta(states, cfg, dyn)
        states, _ = maybe_decay(states, cfg, step_keys[s], dyn)
        pos, vel = fstep(
            states.pos, states.vel, states.ptype, states.alive, dyn.physics_dt, cfg
        )
        states = states.replace(pos=pos, vel=vel)

    pos = _batched_overlap(states.pos, states.alive, k3[:, 1], cfg)
    return states.replace(pos=pos, rng=k3[:, 2].contiguous())


def ensemble_step(
    states: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt=None,
    raw_physics_dt=None,
    force_step_fn=None,
) -> tuple[NucleusState, dict]:
    """One frame of ``num_steps`` substeps over a batch of nuclei.

    Per-nucleus metrics keep their batch axis; the aggregate decay
    statistics are summed on the device. ``force_step_fn`` as in
    :func:`_frame_body`.
    """
    states = _frame_body(
        states, cfg, time_scale, frame_dt, num_steps, physics_dt, raw_physics_dt,
        force_step_fn,
    )
    return states, _ensemble_metrics(states)


def decay_ensemble_step(
    states: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt=None,
    raw_physics_dt=None,
) -> tuple[NucleusState, dict]:
    """Decay-statistics-only frame over a batch: Bernoulli decay, branch
    sampling and the nucleon adjustment, without ejecta, forces or the
    overlap pass, none of which can change which isotope a nucleus is.

    The key tree is :func:`ensemble_step`'s (the force step draws nothing;
    the overlap key is split but unused), so z, n, half_life, decay_counts,
    the chain log and rng equal the full-physics frame's bitwise; positions,
    velocities and ejecta are left as they were. The substeps are one
    :func:`decay_stats_frame` call on a carry cloned once per frame, with
    alive/ptype packed into bitfields once per frame; on the card the
    kernel derives the key tree itself, so none is built here.
    """
    states, dyn = _frame_clock(
        states, cfg, time_scale, frame_dt, num_steps, physics_dt, raw_physics_dt
    )
    carry = states.replace(**{f: getattr(states, f).clone() for f in DECAY_FIELDS})
    bits = pack_nucleon_bits(states.alive, states.ptype)
    rng = decay_stats_frame(carry, bits, states.rng, cfg, dyn, num_steps)
    alive, ptype = unpack_alive_ptype(*bits, states.alive.shape[-1])
    states = carry.replace(alive=alive, ptype=ptype, rng=rng)

    return states, _ensemble_metrics(states)


def make_decay_frame_fn(cfg: SimConfig, num_steps: int):
    """:func:`decay_ensemble_step` for a (config, substep-count) bucket,
    with the frame signature of :func:`make_frame_fn`."""

    def frame(state, time_scale, frame_dt, physics_dt=cfg.effective_dt(),
              raw_physics_dt=cfg.physics_dt):
        return decay_ensemble_step(state, cfg, time_scale, frame_dt, num_steps,
                                   physics_dt, raw_physics_dt)

    return frame


def simulate_frame(
    state: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt=None,
    raw_physics_dt=None,
    force_step_fn=None,
) -> tuple[NucleusState, dict]:
    """One frame of a single nucleus: the ``B = 1`` case of
    :func:`ensemble_step`, with per-nucleus metrics only."""
    if state.batch != 1:
        raise ValueError(f"simulate_frame takes a batch of 1, got {state.batch}")
    state = _frame_body(
        state, cfg, time_scale, frame_dt, num_steps, physics_dt, raw_physics_dt,
        force_step_fn,
    )
    return state, state_metrics(state)


def make_frame_fn(cfg: SimConfig, num_steps: int, batched: bool = False):
    """Frame function for a (config, substep-count) bucket, with the
    JAX package's call signature ``frame(state, time_scale, frame_dt,
    physics_dt=..., raw_physics_dt=...)``."""
    fn = ensemble_step if batched else simulate_frame

    def frame(state, time_scale, frame_dt, physics_dt=cfg.effective_dt(),
              raw_physics_dt=cfg.physics_dt):
        return fn(state, cfg, time_scale, frame_dt, num_steps, physics_dt,
                  raw_physics_dt)

    return frame


def make_run_fn(cfg: SimConfig, num_steps: int, num_frames: int, batched: bool = False):
    """Fused run for a (config, substep-count, frame-count) bucket:
    ``num_frames`` whole frames dispatched back to back with no host
    synchronisation between them, at a constant time scale.

    Returns ``(state, metrics)`` with the metrics of the final state only:
    the frames in between run without theirs. The clock advances per
    frame, and the chain-log ring in the state keeps every event for the
    host to drain afterwards.
    """

    def run(state, time_scale, frame_dt, physics_dt=cfg.effective_dt(),
            raw_physics_dt=cfg.physics_dt):
        if not batched and state.batch != 1:
            raise ValueError(f"a single-nucleus run takes a batch of 1, got {state.batch}")
        for _ in range(num_frames):
            state = _frame_body(state, cfg, time_scale, frame_dt, num_steps,
                                physics_dt, raw_physics_dt)
        return state, _ensemble_metrics(state) if batched else state_metrics(state)

    return run
