"""In-step radioactive decay over a batch of nuclei.

The decay engine of ``pyqmd_tpu.core.decay`` with packed-row table lookups
(``row_tables=True``), batched over a leading ``B``: one Bernoulli draw per
nucleus per substep, a table-row branch pick, removal of the lowest-ranked
alive nucleons, β flips, ejecta written into a fixed ring, counters, and
the chain-log append with the measured-or-synthetic duration record
(nuclear_sim.py:212-353, particles.py:126-203). Every transition is
computed for every nucleus and masked by whether it fired.

Two forms share the transition:

* the full-physics form, which also damps velocities and writes ejecta;
* the statistics form (``stats_only``), which skips both and may carry
  alive/ptype as packed bitfields (:func:`pack_nucleon_bits`). It draws and
  reads only the first four uniforms, so isotope trajectories equal the
  full form's bitwise. It is the plain version of the decay kernel
  (``pyqmd_tpu_torch/kernels/decay.py``).
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


# --- packed nucleon bitfields (statistics form) ------------------------------
#
# The statistics frame carries (alive, is-proton) as ceil(P/32) 32-bit words
# per nucleus: slot j lives in word j // 32, bit j % 32. "The first r alive
# protons" is then a lowest-set-bits extraction over (B, W) words instead of
# a cumsum over (B, P). Removal counts are at most 2 (_REMOVE_P/_REMOVE_N),
# so two x & -x rounds per word suffice. The words ride as int64 masked to
# 32 bits (torch's CPU uint32 has no +, << or >>); for x in [0, 2^32),
# x & -x in int64 is the lowest set bit exactly. Pack/unpack happens once
# per frame; the resulting alive/ptype equal the rank-mask form's bitwise.


def pack_nucleon_bits(alive: torch.Tensor, ptype: torch.Tensor):
    """(..., P) alive/ptype to two (..., W) int64 bitfields (alive bits,
    is-proton bits). The proton bits cover every slot, dead and padding
    too, so ptype survives a pack/unpack round trip (nucleus slots are
    always PROTON or NEUTRON)."""
    p = alive.shape[-1]
    w = -(-p // 32)
    shifts = torch.arange(32, dtype=torch.int64, device=alive.device)

    def pk(v):
        vv = v.to(torch.int64)
        if w * 32 > p:
            vv = torch.cat([vv, vv.new_zeros(vv.shape[:-1] + (w * 32 - p,))], -1)
        return (vv.reshape(vv.shape[:-1] + (w, 32)) << shifts).sum(-1)

    return pk(alive), pk(ptype == PROTON)


def unpack_alive_ptype(alive_bits: torch.Tensor, proton_bits: torch.Tensor, p: int):
    """Inverse of :func:`pack_nucleon_bits`: (..., W) words back to
    (..., P) bool alive and int32 ptype."""
    slot = torch.arange(p, device=alive_bits.device)
    w_idx, b_idx = slot // 32, slot % 32

    def up(x):
        return ((x[..., w_idx] >> b_idx) & 1).bool()

    ptype = torch.where(up(proton_bits), PROTON, NEUTRON).to(torch.int32)
    return up(alive_bits), ptype


def _lowest_set_bits(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Mask of the lowest min(r, popcount) set bits of the (..., W) words
    ``x``, scanning words low to high; ``r`` (...,) is at most 2."""
    out = []
    for wd in range(x.shape[-1]):
        xw = x[..., wd]
        b1 = xw & -xw
        x2 = xw ^ b1
        b2 = x2 & -x2
        k1 = torch.where(r >= 1, b1, 0)
        r = r - (k1 != 0).to(r.dtype)
        k2 = torch.where(r >= 1, b2, 0)
        r = r - (k2 != 0).to(r.dtype)
        out.append(k1 | k2)
    return torch.stack(out, -1)


def _first_set_bit(x: torch.Tensor) -> torch.Tensor:
    """Mask of the single lowest set bit across the (..., W) words ``x``
    (all zero where ``x`` is empty)."""
    out = []
    found = None
    for wd in range(x.shape[-1]):
        b = x[..., wd] & -x[..., wd]
        if found is None:
            out.append(b)
            found = b != 0
        else:
            out.append(torch.where(found, 0, b))
            found = found | (b != 0)
    return torch.stack(out, -1)


def _decay_draw_count(cfg: SimConfig) -> int:
    """Uniform draws consumed by :func:`_apply_decay_from_draws`: branch,
    duration, half-life estimate, fragment count, then per-slot fragment
    types and angles."""
    return 4 + 2 * cfg.max_ejecta_per_event


# Uniforms the statistics form reads: Bernoulli, branch, duration and
# half-life. Draw element c hashes counter c whatever the draw's length,
# so these equal the first four of the full form's draw.
STATS_DRAWS = 4


def apply_decay(
    state: NucleusState, cfg: SimConfig, keys: torch.Tensor, did: torch.Tensor,
    dyn: FrameDynamics,
) -> tuple[NucleusState, torch.Tensor]:
    """Apply one (possibly suppressed) decay event per nucleus, drawing its
    uniforms from ``keys`` (B, 2); ``did`` (B,) says which fire. Returns
    (state, decay type or DECAY_NONE)."""
    u = prng.uniform(keys, (_decay_draw_count(cfg),))
    return _apply_decay_from_draws(state, cfg, u, did, dyn)


def _apply_decay_from_draws(
    state: NucleusState,
    cfg: SimConfig,
    u: torch.Tensor,
    did: torch.Tensor,
    dyn: FrameDynamics,
    stats_only: bool = False,
    packed_nucleons=None,
):
    """Apply one (possibly suppressed) decay event to every nucleus from
    its pre-drawn uniforms ``u`` (B, 4 + 2·k_e). ``did`` (B,) says whether
    the Bernoulli draw fired. Returns (state, decay type or DECAY_NONE).

    ``stats_only`` (the decay-only statistics frame) reads only
    ``u[:, :3]`` and skips the ejecta-ring writes and the velocity damping:
    positions, velocities and ejecta are left as they are, and the isotope
    trajectories (z, n, half_life, decay_counts, chain log) equal the full
    form's. With ``packed_nucleons = (alive_bits, proton_bits)`` (B, W)
    int64 words (stats only), alive/ptype are updated as those bitfields
    instead; ``state.alive`` and ``state.ptype`` are left as they are and
    the new words come back as a third element.
    """
    if packed_nucleons is not None and not stats_only:
        raise ValueError("packed nucleon bitfields are stats-only")
    u_branch, u_dur, u_hl = u[:, 0], u[:, 1], u[:, 2]

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
    # A tensor divisor: CUDA divides a tensor by a Python float as a
    # multiply by its reciprocal, one rounding more than the kernel's.
    synth = torch.minimum(hl_safe * rand_factor / torch.full_like(hl_safe, LN2_REF), alt)
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
    rm_p = _lut(_REMOVE_P, dtype)
    rm_n = _lut(_REMOVE_N, dtype)
    bminus = eff & (dtype == DECAY_BETA_MINUS)
    bplus = eff & (dtype == DECAY_BETA_PLUS)
    updates = {}
    if packed_nucleons is not None:
        ab, pb = packed_nucleons
        apb = ab & pb
        anb = ab & ~pb
        kill = _lowest_set_bits(apb, rm_p) | _lowest_set_bits(anb, rm_n)
        new_ab = ab & ~torch.where(eff[:, None], kill, 0)
        new_pb = (pb | torch.where(bminus[:, None], _first_set_bit(anb), 0)) & ~torch.where(
            bplus[:, None], _first_set_bit(apb), 0
        )
        new_alive = None
    else:
        alive_p, alive_n, prank, nrank = _first_rank_masks(state.alive, state.ptype)
        kill = (alive_p & (prank < rm_p[:, None])) | (alive_n & (nrank < rm_n[:, None]))
        new_alive = state.alive & ~(kill & eff[:, None])
        flip_to_p = bminus[:, None] & alive_n & (nrank == 0)
        flip_to_n = bplus[:, None] & alive_p & (prank == 0)
        new_ptype = torch.where(flip_to_p, PROTON, state.ptype)
        new_ptype = torch.where(flip_to_n, NEUTRON, new_ptype).to(torch.int32)
        updates.update(alive=new_alive, ptype=new_ptype)

    if not stats_only:
        updates.update(_ejecta_updates(state, cfg, dyn, u, eff, dtype, new_alive))

    z2 = torch.where(eff, new_z, state.z)
    n2 = torch.where(eff, new_n, state.n)
    hl2 = torch.where(
        eff, tables.half_life_from_row(tables.lookup_row(new_z, new_n), u_hl), hl
    )
    counts = state.decay_counts
    count_slot = torch.arange(counts.shape[-1], device=u.device) == dtype[:, None]

    new_state = state.replace(
        **updates,
        z=z2,
        n=n2,
        half_life=hl2,
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
    dtype_out = torch.where(eff, dtype, DECAY_NONE)
    if packed_nucleons is not None:
        return new_state, dtype_out, (new_ab, new_pb)
    return new_state, dtype_out


def _ejecta_updates(state, cfg, dyn, u, eff, dtype, new_alive) -> dict:
    """The full form's velocity damping and ejecta-ring writes of a decay
    event: fragments spawn at the post-adjustment centre of mass
    (nuclear_sim.py:290-313)."""
    k_e = cfg.max_ejecta_per_event
    u_nfrag = u[:, 3]
    u_ftype = u[:, 4:4 + k_e]
    u_ang = u[:, 4 + k_e:4 + 2 * k_e]

    damp = eff & _lut(_APPLIES_DAMPING, dtype)
    new_vel = torch.where(damp[:, None, None], state.vel * cfg.decay_damping, state.vel)

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
    return dict(
        vel=new_vel,
        ej_pos=ej_set(state.ej_pos, com[:, None, :].expand(b, k_e, 2)),
        ej_vel=ej_set(state.ej_vel, frag_vel),
        ej_type=ej_set(state.ej_type, frag_type),
        ej_age=ej_set(state.ej_age, torch.zeros_like(frag_life)),
        ej_life=ej_set(state.ej_life, frag_life),
        ej_alive=ej_set(state.ej_alive, torch.ones_like(frag_active)),
        ej_cursor=state.ej_cursor + frag_active.to(torch.int32).sum(-1, dtype=torch.int32),
    )


def maybe_decay(
    state: NucleusState,
    cfg: SimConfig,
    keys: torch.Tensor,
    dyn: FrameDynamics,
    stats_only: bool = False,
    packed_nucleons=None,
):
    """Bernoulli decay check for one substep (nuclear_sim.py:164-167): one
    uniform vector per nucleus from its substep key ``keys`` (B, 2) feeds
    the Bernoulli draw and every event draw. The statistics form draws only
    the :data:`STATS_DRAWS` uniforms it reads; ``stats_only`` and
    ``packed_nucleons`` as in :func:`_apply_decay_from_draws`."""
    n_draws = STATS_DRAWS if stats_only else 1 + _decay_draw_count(cfg)
    u = prng.uniform(keys, (n_draws,))
    return maybe_decay_from_u(state, cfg, u, dyn, stats_only, packed_nucleons)


def maybe_decay_from_u(
    state: NucleusState,
    cfg: SimConfig,
    u: torch.Tensor,
    dyn: FrameDynamics,
    stats_only: bool = False,
    packed_nucleons=None,
):
    """:func:`maybe_decay` over pre-drawn uniforms ``u`` (B, 1 + draws)."""
    p = decay_probability(state.half_life, dyn.step_time)
    did = u[:, 0] < p
    return _apply_decay_from_draws(
        state, cfg, u[:, 1:], did, dyn, stats_only, packed_nucleons
    )


def force_decay(
    state: NucleusState, cfg: SimConfig, keys: torch.Tensor, dyn: FrameDynamics
) -> tuple[NucleusState, torch.Tensor]:
    """Unconditional decay of every nucleus, the fault-injection hook
    (nuclear_sim.py:433-434)."""
    did = torch.ones(state.z.shape, dtype=torch.bool, device=state.z.device)
    return apply_decay(state, cfg, keys, did, dyn)
