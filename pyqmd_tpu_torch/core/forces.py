"""Pairwise nuclear force + integration: the plain PyTorch version.

Physics of ``pyqmd_tpu.core.forces`` term for term (reference
nuclear_forces.py:60-172): hard core inside 1.7 nucleon radii, the
piecewise strong force with one shared exp, p-p Coulomb, same-type Pauli,
per-pair clamp to ±12, the centre-of-mass spring outside 1.5·R(A) with
R = 1.2·A^(1/3)·2, and semi-implicit Euler with 0.85 damping (or
kick-drift-kick leapfrog).

Every function takes any leading batch dims. This is the version CPU
tensors run (:func:`pyqmd_tpu_torch.kernels.forces.force_step` dispatches
here) and the oracle the CUDA kernel is held against. It materialises
(B, P, P) pair temporaries, so :func:`force_step` chunks large batches.

Pair offsets are differences of positions, never a matrix product on
absolute coordinates: at ~400-unit coordinates the latter cancels
catastrophically in f32.
"""

from __future__ import annotations

import torch

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.state import PROTON


def _rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` rounded as one division. (PyTorch evaluates
    ``float / tensor`` as ``t.reciprocal() * float``, two roundings.)"""
    return torch.full_like(t, num) / t


def sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as XLA and CUDA's ``sqrtf`` give
    it. PyTorch's vectorised CPU sqrt misses by one ULP on ~0.6% of inputs,
    enough to move a pair across a cut of the force law; the f64 root of
    an f32 rounds to the correct f32."""
    return torch.sqrt(t.double()).float()


def pair_net_force(dist, dist2, is_pp, is_same, cfg: SimConfig):
    """Radial force magnitude of each pair at distance ``dist``; positive =
    attractive. Matches nuclear_forces.py:100-137 term for term."""
    eps = cfg.epsilon
    s = cfg.strong_strength

    # Hard-core repulsion; x**1.5 as x*sqrt(x).
    min_allowed = cfg.nucleon_radius * cfg.hard_core_scale
    overlap = torch.clamp(min_allowed - dist, min=0.0) / min_allowed
    f = -cfg.hard_core_strength * overlap * sqrt_rn(overlap)

    # Piecewise strong force: the attract and tail branches share one exp
    # by selecting the exponent scale first.
    r_ratio = dist / cfg.strong_range
    in_attract = dist < cfg.strong_attract_cut
    amp = torch.where(in_attract, 1.25 * s, 0.15 * s)
    k = torch.where(in_attract, 1.0, 1.8)
    outer = amp * torch.exp(-r_ratio * k) / (dist + eps)
    core = _rdiv(-0.7 * s, dist2 + eps)
    f = f + torch.where(dist < cfg.strong_core_cut, core, outer)

    # Coulomb repulsion, proton-proton only.
    f = f - torch.where(is_pp, _rdiv(cfg.coulomb_strength, dist2 + eps), 0.0)

    # Pauli exclusion, same-type pairs within range.
    pauli = cfg.pauli_strength * torch.exp(-dist / cfg.pauli_range * 2.0)
    f = f - torch.where(is_same & (dist < cfg.pauli_range), pauli, 0.0)

    return torch.clamp(f, -cfg.max_pair_force, cfg.max_pair_force)


def com_force(pos, center, count, cfg: SimConfig):
    """Centre-of-mass containment spring (nuclear_forces.py:144-154).

    ``pos`` (..., P, 2), ``center`` (..., 2), ``count`` (...) the alive
    count (at least 1). Returns the (..., P, 2) force contribution.
    """
    cd = center[..., None, :] - pos
    cdist = sqrt_rn((cd * cd).sum(-1))
    nuclear_radius = (1.2 * count ** (1.0 / 3.0) * 2.0)[..., None]
    active = (cdist > nuclear_radius * 1.5) & (cdist > 0.01)
    mag = cfg.com_spring * (cdist - nuclear_radius)
    scale = torch.where(active, mag / torch.clamp(cdist, min=1e-9), 0.0)
    return cd * scale[..., None]


def pair_forces_block(pos_i, type_i, alive_i, pos_j, type_j, alive_j, cfg: SimConfig):
    """Pair-force sum of a j-block on an i-block: (..., Ni, 2).

    Self-pairs and coincident pairs drop out through the kernel's
    ``dist2 < 0.01`` guard (nuclear_forces.py:96).
    """
    d = pos_j[..., None, :, :] - pos_i[..., :, None, :]  # d[i, j] = pos_j - pos_i
    dist2 = (d * d).sum(-1)
    pair = alive_i[..., :, None] & alive_j[..., None, :] & (dist2 >= 0.01)

    dist = sqrt_rn(torch.clamp(dist2, min=1e-12))
    ip_i = type_i == PROTON
    ip_j = type_j == PROTON
    is_pp = ip_i[..., :, None] & ip_j[..., None, :]
    is_same = type_i[..., :, None] == type_j[..., None, :]

    net = pair_net_force(dist, dist2, is_pp, is_same, cfg)
    g = torch.where(pair, net / dist, 0.0)  # force magnitude / dist
    return (g[..., None] * d).sum(-2)


def compute_forces(pos, ptype, alive, cfg: SimConfig):
    """Total per-particle force (..., P, 2): pair terms + CoM spring."""
    m = alive
    count = m.to(torch.float32).sum(-1)
    safe_count = torch.clamp(count, min=1.0)
    center = (pos * m[..., None]).sum(-2) / safe_count[..., None]

    force = pair_forces_block(pos, ptype, m, pos, ptype, m, cfg)
    return force + com_force(pos, center, safe_count, cfg) * m[..., None]


def chunk_plan(b: int, max_chunk: int):
    """Minimal-waste batch chunking: ``(n_chunks, chunk, pad)`` — the
    fewest chunks that respect ``max_chunk``, sized evenly."""
    n_chunks = -(-b // max_chunk)
    chunk = -(-b // n_chunks)
    return n_chunks, chunk, n_chunks * chunk - b


def force_step(pos, vel, ptype, alive, dt, cfg: SimConfig, *, max_chunk=8192):
    """One force + integrate substep (nuclear_forces.py:156-171) over a
    batch: pos/vel (B, P, 2), ptype/alive (B, P). Semi-implicit Euler
    ``v += F·dt; v *= damping; x += v·dt`` or leapfrog per
    ``cfg.integrator``, ``dt`` a float or a 0-d f32 tensor on the batch's
    device (the same bits either way). Dead slots pass through unchanged.

    Batches above ``max_chunk`` run in ``chunk_plan`` chunks, bounding the
    (chunk, P, P) pair temporaries."""
    b = pos.shape[0]
    if b > max_chunk:
        _, chunk, _ = chunk_plan(b, max_chunk)
        outs = [
            force_step(pos[s:s + chunk], vel[s:s + chunk], ptype[s:s + chunk],
                       alive[s:s + chunk], dt, cfg, max_chunk=max_chunk)
            for s in range(0, b, chunk)
        ]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
    if not isinstance(dt, torch.Tensor):
        dt = float(dt)
    if cfg.integrator == "leapfrog":
        return _leapfrog_step(pos, vel, ptype, alive, dt, cfg)
    force = compute_forces(pos, ptype, alive, cfg)
    new_vel = (vel + force * dt) * cfg.damping
    new_pos = pos + new_vel * dt
    m = alive[..., None]
    return torch.where(m, new_pos, pos), torch.where(m, new_vel, vel)


def _leapfrog_step(pos, vel, ptype, alive, dt, cfg: SimConfig):
    """Velocity-Verlet (kick-drift-kick): two force evaluations, damping
    once at the end."""
    f1 = compute_forces(pos, ptype, alive, cfg)
    v_half = vel + f1 * (0.5 * dt)
    new_pos = pos + v_half * dt
    f2 = compute_forces(new_pos, ptype, alive, cfg)
    new_vel = (v_half + f2 * (0.5 * dt)) * cfg.damping
    m = alive[..., None]
    return torch.where(m, new_pos, pos), torch.where(m, new_vel, vel)
