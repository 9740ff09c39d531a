"""In-step radioactive decay over a batch of nuclei.

The full-physics form of ``pyqmd_tpu.core.decay`` with packed-row table
lookups (``row_tables=True``), batched over a leading ``B``: one
Bernoulli draw per nucleus per substep, a table-row branch pick, removal
of the lowest-ranked alive nucleons by rank masks, β flips, ejecta written
into a fixed ring, counters, and the chain-log append with the
measured-or-synthetic duration record (nuclear_sim.py:212-353,
particles.py:126-203). Every transition is computed for every nucleus and
masked by whether it fired.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pyqmd_tpu_torch import prng
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core.dynamics import FrameDynamics
from pyqmd_tpu_torch.data import tables
from pyqmd_tpu_torch.state import (
    ALPHA,
    BASE_LIFETIMES,
    DECAY_BETA_MINUS,
    DECAY_BETA_PLUS,
    DECAY_NONE,
    DECAY_SPONTANEOUS_FISSION,
    EJECTA_SPEEDS,
    ELECTRON,
    GAMMA,
    NEUTRON,
    POSITRON,
    PROTON,
    NucleusState,
)

LN2_REF = 0.693  # the reference's truncated ln(2) (particles.py:140)

# Ejecta particle type emitted per decay mode (decay_chains.py:235-243,
# :331-371). Fission is handled separately.
_DECAY_EJECTA_TYPE = np.array(
    [0, ALPHA, ELECTRON, POSITRON, GAMMA, NEUTRON, PROTON, ALPHA], np.int32
)

# Nucleons removed per decay mode: (protons, neutrons) (particles.py:155-177).
_REMOVE_P = np.array([0, 2, 0, 0, 0, 0, 1, 0], np.int32)
_REMOVE_N = np.array([0, 2, 0, 0, 0, 1, 0, 0], np.int32)

# Modes whose adjust_particles path applies the 0.8 velocity damping
# (particles.py:200-203; the beta branches return before it, :158-171).
_APPLIES_DAMPING = np.array([0, 1, 0, 0, 0, 1, 1, 0], bool)

_TWO_PI = 2.0 * math.pi


def _lut(table: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """Gather ``table[idx]`` from the copy of ``table`` on ``idx``'s device."""
    return tables.on_device(table, idx.device)[idx.to(torch.int64)]


def decay_probability(half_life: torch.Tensor, dt: np.float32) -> torch.Tensor:
    """Dual-regime decay probability (particles.py:126-147): exact
    ``1 - 0.5**(dt/T)`` when dt is large relative to the half-life,
    linearised ``0.693/T * dt`` otherwise, clamped to [0, 1]; stable
    nuclei (T = inf) never decay."""
    dt = float(dt)
    hl = torch.clamp(half_life, min=1e-30)
    big = 1.0 - tables.exp2(torch.full_like(hl, -dt) / hl)
    small = torch.full_like(hl, LN2_REF) / hl * dt
    p = torch.where(dt > hl * 0.01, big, small)
    p = torch.clamp(p, 0.0, 1.0)
    return torch.where(torch.isinf(half_life), 0.0, p)


def ejecta_lifetime(frag_type: torch.Tensor, dyn: FrameDynamics, cfg: SimConfig):
    """Ejecta lifetime with the reference's time-scale/substep/dt
    compensation (nuclear_sim.py:315-342)."""
    base = cfg.base_ejecta_lifetime
    ts, ss = dyn.time_scale, dyn.substeps
    # The dt factor reads the raw physics dt (nuclear_sim.py:327).
    pdt = dyn.raw_physics_dt if dyn.raw_physics_dt is not None else dyn.physics_dt
    if ts > 1.0:
        tf = np.maximum(np.float32(1.0), ts / np.float32(100.0))
        sf = np.maximum(np.float32(1.0), np.sqrt(ss))
        df = np.maximum(np.float32(1.0), np.float32(0.016) / pdt)
        fast = np.maximum(base * sf, base * tf * sf * df)
        if ss > 15.0:
            fast = fast * (ss / np.float32(15.0))
        return torch.full(frag_type.shape, float(fast), device=frag_type.device)
    # Slow/real-time branch: at least the per-type base lifetime.
    floor = float(base * np.maximum(np.float32(1.0), ss / np.float32(5.0)))
    return torch.clamp(_lut(BASE_LIFETIMES, frag_type), min=floor)


def _first_rank_masks(alive: torch.Tensor, ptype: torch.Tensor):
    """Per-slot rank among alive protons / neutrons (lowest index = rank
    0): the masked form of the reference's first-in-list scans
    (particles.py:158-189)."""
    alive_p = alive & (ptype == PROTON)
    alive_n = alive & (ptype == NEUTRON)
    prank = torch.cumsum(alive_p.to(torch.int32), -1, dtype=torch.int32) - 1
    nrank = torch.cumsum(alive_n.to(torch.int32), -1, dtype=torch.int32) - 1
    return alive_p, alive_n, prank, nrank


def _decay_draw_count(cfg: SimConfig) -> int:
    """Uniform draws consumed by :func:`_apply_decay_from_draws`: branch,
    duration, half-life estimate, fragment count, then per-slot fragment
    types and angles."""
    return 4 + 2 * cfg.max_ejecta_per_event


def _apply_decay_from_draws(
    state: NucleusState,
    cfg: SimConfig,
    u: torch.Tensor,
    did: torch.Tensor,
    dyn: FrameDynamics,
) -> tuple[NucleusState, torch.Tensor]:
    """Apply one (possibly suppressed) decay event to every nucleus from
    its pre-drawn uniforms ``u`` (B, 4 + 2·k_e). ``did`` (B,) says whether
    the Bernoulli draw fired. Returns (state, decay type or DECAY_NONE)."""
    k_e = cfg.max_ejecta_per_event
    u_branch, u_dur, u_hl, u_nfrag = u[:, 0], u[:, 1], u[:, 2], u[:, 3]
    u_ftype = u[:, 4:4 + k_e]
    u_ang = u[:, 4 + k_e:4 + 2 * k_e]

    new_z, new_n, dtype = tables.sample_branch_from_row(
        tables.lookup_row(state.z, state.n), u_branch
    )
    eff = did & (dtype != DECAY_NONE)
    effi = eff.to(torch.int32)

    # Chain-record duration: measured sim time since the last decay, or an
    # Exp(T/ln2)-distributed synthetic draw when it rounds to zero
    # (nuclear_sim.py:239-255).
    measured = state.time_passed - state.last_decay_time
    hl = state.half_life
    hl_inf = torch.isinf(hl)
    hl_safe = torch.where(hl_inf, 1.0, hl)
    rand_factor = -torch.log(torch.clamp(u_dur, min=1e-20))
    alt = torch.where(measured > 0.0, measured, hl_safe)
    synth = torch.minimum(hl_safe * rand_factor / LN2_REF, alt)
    synth = torch.where(hl_inf, 0.0, synth)
    duration = torch.where((measured < 0.001) | (hl < 0.001), synth, measured)

    # Chain-ring append at slot cursor % L.
    slot = state.chain_cursor % cfg.max_chain_log
    ring = torch.arange(cfg.max_chain_log, device=u.device)
    slot_mask = (ring == slot[:, None]) & eff[:, None]

    def masked_set(arr, value):
        return torch.where(slot_mask, value[:, None], arr)

    # Nucleon adjustment (particles.py:149-203): remove the lowest-ranked
    # alive protons/neutrons, flip the first neutron (β-) or proton (β+).
    rm_p = _lut(_REMOVE_P, dtype)[:, None]
    rm_n = _lut(_REMOVE_N, dtype)[:, None]
    alive_p, alive_n, prank, nrank = _first_rank_masks(state.alive, state.ptype)
    kill = (alive_p & (prank < rm_p)) | (alive_n & (nrank < rm_n))
    new_alive = state.alive & ~(kill & eff[:, None])
    flip_to_p = (eff & (dtype == DECAY_BETA_MINUS))[:, None] & alive_n & (nrank == 0)
    flip_to_n = (eff & (dtype == DECAY_BETA_PLUS))[:, None] & alive_p & (prank == 0)
    new_ptype = torch.where(flip_to_p, PROTON, state.ptype)
    new_ptype = torch.where(flip_to_n, NEUTRON, new_ptype).to(torch.int32)

    damp = eff & _lut(_APPLIES_DAMPING, dtype)
    new_vel = torch.where(damp[:, None, None], state.vel * cfg.decay_damping, state.vel)

    # Ejecta spawn at the post-adjustment centre of mass
    # (nuclear_sim.py:290-294).
    w = new_alive.to(torch.float32)
    cnt = torch.clamp(w.sum(-1), min=1.0)
    com = (state.pos * w[..., None]).sum(-2) / cnt[:, None]

    is_fission = dtype == DECAY_SPONTANEOUS_FISSION
    # randint(2, 3) inclusive (decay_chains.py:377).
    nfrag_fission = 2 + (u_nfrag < 0.5).to(torch.int32)
    nfrag = torch.where(is_fission, nfrag_fission, 1)
    frag_idx = torch.arange(k_e, device=u.device)
    frag_active = eff[:, None] & (frag_idx < nfrag[:, None])

    # Fission fragments are alpha with p=0.7 else neutron
    # (decay_chains.py:383-388); other modes emit a fixed type.
    fission_type = torch.where(u_ftype < 0.7, ALPHA, NEUTRON)
    frag_type = torch.where(
        is_fission[:, None], fission_type, _lut(_DECAY_EJECTA_TYPE, dtype)[:, None]
    ).to(torch.int32)

    # Random angle at the per-type base speed (nuclear_sim.py:296-313).
    angles = u_ang * _TWO_PI
    speed = _lut(EJECTA_SPEEDS, frag_type)
    frag_vel = speed[..., None] * torch.stack([torch.cos(angles), torch.sin(angles)], -1)
    frag_life = ejecta_lifetime(frag_type, dyn, cfg)

    # Ejecta-ring write: ring slot s receives fragment k iff
    # (s - cursor) mod E == k.
    e_cap = cfg.max_ejecta
    rel = (torch.arange(e_cap, device=u.device) - state.ej_cursor[:, None]) % e_cap

    def ej_set(arr, value):
        """``value`` (B, k_e, ...) written into ring ``arr`` (B, E, ...)."""
        out = arr
        for k in range(k_e):
            mask = (rel == k) & frag_active[:, k:k + 1]
            if arr.dim() > 2:
                mask = mask[..., None]
            out = torch.where(mask, value[:, k:k + 1], out)
        return out

    b = u.shape[0]
    z2 = torch.where(eff, new_z, state.z)
    n2 = torch.where(eff, new_n, state.n)
    hl2 = torch.where(
        eff, tables.half_life_from_row(tables.lookup_row(new_z, new_n), u_hl), hl
    )
    counts = state.decay_counts
    count_slot = torch.arange(counts.shape[-1], device=u.device) == dtype[:, None]

    new_state = state.replace(
        vel=new_vel,
        ptype=new_ptype,
        alive=new_alive,
        z=z2,
        n=n2,
        half_life=hl2,
        ej_pos=ej_set(state.ej_pos, com[:, None, :].expand(b, k_e, 2)),
        ej_vel=ej_set(state.ej_vel, frag_vel),
        ej_type=ej_set(state.ej_type, frag_type),
        ej_age=ej_set(state.ej_age, torch.zeros_like(frag_life)),
        ej_life=ej_set(state.ej_life, frag_life),
        ej_alive=ej_set(state.ej_alive, torch.ones_like(frag_active)),
        ej_cursor=state.ej_cursor + frag_active.to(torch.int32).sum(-1, dtype=torch.int32),
        decay_counts=torch.where(count_slot, counts + effi[:, None], counts),
        last_decay_time=torch.where(eff, state.time_passed, state.last_decay_time),
        chain_z0=masked_set(state.chain_z0, state.z),
        chain_n0=masked_set(state.chain_n0, state.n),
        chain_dtype=masked_set(state.chain_dtype, dtype),
        chain_z1=masked_set(state.chain_z1, new_z),
        chain_n1=masked_set(state.chain_n1, new_n),
        chain_time=masked_set(state.chain_time, duration * eff.to(torch.float32)),
        chain_cursor=state.chain_cursor + effi,
    )
    return new_state, torch.where(eff, dtype, DECAY_NONE)


def maybe_decay(
    state: NucleusState, cfg: SimConfig, keys: torch.Tensor, dyn: FrameDynamics
):
    """Bernoulli decay check for one substep (nuclear_sim.py:164-167): one
    uniform vector per nucleus from its substep key ``keys`` (B, 2) feeds
    the Bernoulli draw and every event draw."""
    u = prng.uniform(keys, (1 + _decay_draw_count(cfg),))
    return maybe_decay_from_u(state, cfg, u, dyn)


def maybe_decay_from_u(
    state: NucleusState, cfg: SimConfig, u: torch.Tensor, dyn: FrameDynamics
):
    """:func:`maybe_decay` over pre-drawn uniforms ``u`` (B, 1 + draws)."""
    p = decay_probability(state.half_life, dyn.step_time)
    did = u[:, 0] < p
    return _apply_decay_from_draws(state, cfg, u[:, 1:], did, dyn)
