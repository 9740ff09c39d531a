"""The frames written out plainly: the full-physics frame, the
decay-statistics frame, the survival curve and the picture.

Each follows the program's semantics step for step (reference
nuclear_sim.py:118-176 and the JAX package's key tree), with the plain
force, overlap and decay versions of this package and no graph, kernel or
cache. Every frame works on blocks of :data:`BLOCK` members, so that its
(block, P, P) pair temporaries fit beside whatever else is on the device;
members are independent, so the blocks give the whole batch's answer.

``round_to`` stores positions and velocities (full frame) or half-lives
(statistics frame) in a lower float precision after every substep: the
control that a comparison has to fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import prng
from benchmark.reference.config import SimConfig
from benchmark.reference.decay import maybe_decay, pack_nucleon_bits, unpack_alive_ptype
from benchmark.reference.dynamics import frame_dynamics, frame_scalars
from benchmark.reference.forces import force_step
from benchmark.reference.framebuffer import render_frame
from benchmark.reference.init import ensemble_init
from benchmark.reference.overlap import _rand_u, resolve_overlaps
from benchmark.reference.state import ALPHA, NucleusState

TIME_SCALE_PRESETS = {"billion": 31557600000000000.0}

BLOCK = 1024  # members per block of a frame


def config_from_file(cfg: dict, mode: str) -> SimConfig:
    """The SimConfig a configuration file states. ``max_chain_log`` may be a
    mapping from the run's mode (``ensemble``, ``single``) to the ring's
    length."""
    fields = dict(cfg["sim_config"])
    ring = fields.get("max_chain_log")
    if isinstance(ring, dict):
        fields["max_chain_log"] = ring[mode]
    return SimConfig(**fields)


def schedule(cfg: SimConfig, time_scale: float, frame_dt: float) -> tuple[int, float]:
    """Substeps and effective physics dt of a frame (nuclear_sim.py:131-154,
    auto-adjust off)."""
    effective = cfg.physics_dt * (2.0 - cfg.accuracy)
    num = max(1, min(cfg.max_substeps, int(frame_dt * time_scale / effective)))
    return num, effective


def _rounded(t: torch.Tensor, round_to) -> torch.Tensor:
    return t if round_to is None else t.to(round_to).to(t.dtype)


def advance_ejecta(state: NucleusState, sc) -> NucleusState:
    """Ejecta advection, ageing and expiry (nuclear_sim.py:178-210)."""
    is_anim = state.ej_type >= ALPHA
    step = torch.where(is_anim, sc.anim_step, sc.nucleon_step)
    live = state.ej_alive
    new_pos = state.ej_pos + state.ej_vel * torch.where(live, step, 0.0)[..., None]
    age_inc = torch.where(is_anim, sc.anim_age_inc, sc.step_time)
    new_age = state.ej_age + torch.where(live, age_inc, 0.0)
    expired = is_anim & (new_age >= state.ej_life)
    return state.replace(ej_pos=new_pos, ej_age=new_age, ej_alive=live & ~expired)


def state_metrics(state: NucleusState) -> dict:
    """Per-nucleus metrics and the ensemble aggregates of a frame."""
    m = {
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
    m["total_decay_counts"] = m["decay_counts"].sum(0, dtype=torch.int32)
    m["total_alive"] = m["alive"].sum(dtype=torch.int32)
    return m


def rows(state: NucleusState, s: slice) -> NucleusState:
    return NucleusState(**{f: getattr(state, f)[s] for f in state.__dataclass_fields__})


def _cat(parts: list[NucleusState]) -> NucleusState:
    return NucleusState(**{
        f: torch.cat([getattr(p, f) for p in parts]) for f in parts[0].__dataclass_fields__
    })


def full_frame(state: NucleusState, cfg: SimConfig, time_scale: float, frame_dt: float,
               num_steps: int, physics_dt: float, raw_physics_dt, *,
               round_to=None) -> tuple[NucleusState, dict]:
    """One full-physics frame: clock, key tree (base -> substeps, overlap,
    next), per substep ejecta, decay check, force and integration, then one
    overlap projection per ``cfg.overlap_iterations``; the metrics of the
    new state. ``raw_physics_dt`` None is the sharded frames' form."""
    dyn = frame_dynamics(cfg, time_scale, frame_dt, num_steps, physics_dt, raw_physics_dt)
    sc = frame_scalars(dyn, cfg, state.pos.device)
    outs = []
    for s in range(0, state.batch, BLOCK):
        st = rows(state, slice(s, s + BLOCK))
        st = st.replace(time_passed=st.time_passed + sc.desired_dt)
        k3 = prng.split(st.rng, 3)
        step_keys = prng.split(k3[:, 0], num_steps).transpose(0, 1)
        for i in range(num_steps):
            st = advance_ejecta(st, sc)
            st, _ = maybe_decay(st, cfg, step_keys[i], sc)
            pos, vel = force_step(st.pos, st.vel, st.ptype, st.alive, sc.physics_dt, cfg)
            st = st.replace(pos=_rounded(pos, round_to), vel=_rounded(vel, round_to))
        pos = st.pos
        for i in range(cfg.overlap_iterations):
            u = _rand_u(prng.fold_in(k3[:, 1], i), pos.shape[-2])
            pos = _rounded(resolve_overlaps(pos, st.alive, u, cfg), round_to)
        outs.append(st.replace(pos=pos, rng=k3[:, 2].contiguous()))
    new = _cat(outs)
    return new, state_metrics(new)


def stats_frame(state: NucleusState, cfg: SimConfig, time_scale: float, frame_dt: float,
                num_steps: int, *, round_to=None) -> NucleusState:
    """One decay-statistics frame: the full frame's key tree and decay
    checks on the decay carry, alive/ptype through their bitfields, with
    no ejecta, force or overlap."""
    dyn = frame_dynamics(cfg, time_scale, frame_dt, num_steps, cfg.effective_dt(),
                         cfg.physics_dt)
    st = state.replace(time_passed=state.time_passed + dyn.desired_dt)
    if round_to is not None:
        st = st.replace(half_life=_rounded(st.half_life, round_to))
    bits = pack_nucleon_bits(st.alive, st.ptype)
    k3 = prng.split(st.rng, 3)
    step_keys = prng.split(k3[:, 0], num_steps).transpose(0, 1)
    for i in range(num_steps):
        st, _, bits = maybe_decay(st, cfg, step_keys[i], dyn, stats_only=True,
                                  packed_nucleons=bits)
    alive, ptype = unpack_alive_ptype(*bits, st.alive.shape[-1])
    return st.replace(alive=alive, ptype=ptype, rng=k3[:, 2].contiguous())


def survival_curve(cfg: SimConfig, batch: int, frames: int, half_lives: float, substeps: int,
                   seed: int, tabulated_half_life: float, device, *, round_to=None) -> dict:
    """The survival curve of a fresh ``batch``-member ensemble: survivors
    (members still in the initial isotope) after each frame, the decay
    totals at the end and the endpoint fit ``T = ln2 t_end / -ln S``."""
    state = ensemble_init(cfg, batch, seed=seed, device=device)
    sim_dt = half_lives * tabulated_half_life / frames
    survivors = [batch]
    for _ in range(frames):
        state = stats_frame(state, cfg, sim_dt, 1.0, substeps, round_to=round_to)
        survivors.append(int(((state.z == cfg.z) & (state.n == cfg.n)).sum()))
    s_end = survivors[-1] / batch
    t_end = frames * sim_dt
    fitted = math.inf if s_end >= 1.0 else math.log(2) * t_end / -math.log(max(s_end, 1e-12))
    return {
        "survivors": np.asarray(survivors, np.int64),
        "decay_counts": state.decay_counts.sum(0).cpu().numpy(),
        "fitted_half_life": fitted,
    }


def picture(state: NucleusState, camera, zoom, width: int, height: int,
            index: int = 0) -> np.ndarray:
    """The (H, W, 3) uint8 picture of member ``index`` as a viewer shows
    it, on the host."""
    return render_frame(state, camera, zoom, width, height, True, index).cpu().numpy()
