"""Nucleus initialisation: magic-number shell placement, batched over keys.

The initialiser of ``pyqmd_tpu.core.init`` (reference particles.py:62-124):
nucleons go on shells with capacities [2, 8, 20, 28, 50, 82, 126] inside
radius ``1.2·A^(1/3)·0.7``, alternating proton/neutron pairs per shell then
remainders, each placement taking the best of 20 random angles by the
largest minimum distance to already-placed same-type nucleons. The
placement order is a static numpy plan; the sequential search is a Python
loop over nucleons whose candidate scoring is batched over the ensemble.
All draws follow the reference's key tree, so identities and RNG streams
equal the JAX package's bitwise.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pyqmd_tpu_torch import prng
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core.forces import sqrt_rn
from pyqmd_tpu_torch.data import tables
from pyqmd_tpu_torch.state import DECAY_NONE, NEUTRON, PROTON, NucleusState, empty_state
from pyqmd_tpu_torch.utils.profiling import annotate

SHELL_CAPACITY = (2, 8, 20, 28, 50, 82, 126)
_N_CANDIDATES = 20


def placement_order(z: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Static placement plan: (shell_index, is_proton) per particle index
    (particles.py:105-124): proton/neutron pairs per shell up to half the
    shell capacity, the shell index clamping at the last shell, then
    proton remainders, then neutron remainders."""
    last = len(SHELL_CAPACITY) - 1
    order: list[tuple[int, bool]] = []
    pp = pn = 0
    si = 0
    while pp < z and pn < n:
        size = SHELL_CAPACITY[min(si, last)]
        pairs = min(size // 2, min(z - pp, n - pn))
        for _ in range(pairs):
            order.append((min(si, last), True))
            pp += 1
            order.append((min(si, last), False))
            pn += 1
        si += 1
        if si > last:
            si = last
    while pp < z:
        order.append((min(si, last), True))
        pp += 1
    while pn < n:
        order.append((min(si, last), False))
        pn += 1
    shell_idx = np.array([s for s, _ in order], np.int32)
    is_proton = np.array([p for _, p in order], bool)
    return shell_idx, is_proton


def _ptype_plan(cfg: SimConfig) -> np.ndarray:
    _, is_proton = placement_order(cfg.z, cfg.n)
    types = np.where(is_proton, PROTON, NEUTRON).astype(np.int32)
    return np.pad(types, (0, cfg.max_particles - cfg.a))


def _place_shells(cfg: SimConfig, place_keys: torch.Tensor) -> torch.Tensor:
    """Sequential best-of-20 shell placement for every key in
    ``place_keys`` (B, 2); returns (B, P, 2) positions."""
    device = place_keys.device
    a, p = cfg.a, cfg.max_particles
    shell_idx, _ = placement_order(cfg.z, cfg.n)
    # Shell radii (particles.py:64-68): A^(1/3) scaling, 7 even shells.
    nuclear_radius = 1.2 * a ** (1.0 / 3.0)
    n_shells = len(SHELL_CAPACITY)
    shell_radii = nuclear_radius * 0.7 * (np.arange(n_shells) + 1) / n_shells
    base_radius = shell_radii[shell_idx].astype(np.float32)
    ptype = _ptype_plan(cfg)
    origin = torch.tensor([cfg.origin_x, cfg.origin_y], dtype=torch.float32, device=device)

    b = place_keys.shape[0]
    pos = origin.expand(b, p, 2).clone()
    batch = torch.arange(b, device=device)
    k = place_keys
    for i in range(a):
        k3 = prng.split(k, 3)
        k, kr, ka = k3[:, 0], k3[:, 1], k3[:, 2]
        # Radius jitter 0.8-1.0x the shell radius (particles.py:75).
        radius = float(base_radius[i]) * (0.8 + 0.2 * prng.uniform(kr))
        angles = prng.uniform(ka, (_N_CANDIDATES,), maxval=2.0 * math.pi)
        cand = origin + radius[:, None, None] * torch.stack(
            [torch.cos(angles), torch.sin(angles)], dim=-1
        )  # (B, 20, 2)
        # Min distance to already-placed same-type nucleons (particles.py:84-93).
        same = np.flatnonzero(ptype[:i] == ptype[i])
        if same.size == 0:
            # No same-type nucleon yet: every candidate scores inf and the
            # reference's `min_dist == inf` check makes the last one win
            # (particles.py:91-93).
            sel = torch.full((b,), _N_CANDIDATES - 1, dtype=torch.int64, device=device)
        else:
            placed = pos[:, torch.from_numpy(same).to(device)]  # (B, S, 2)
            diff = cand[:, :, None, :] - placed[:, None, :, :]
            dmin = sqrt_rn((diff * diff).sum(-1)).amin(-1)  # (B, 20)
            sel = torch.argmax(dmin, dim=-1)
        # In place: row i is written once, and only this loop reads pos.
        pos[:, i] = cand[batch, sel]
    return pos


def _member_identity(cfg: SimConfig, keys: torch.Tensor) -> NucleusState:
    """Everything of fresh members except placement geometry: types,
    alive mask, (Z, N), per-member half-life draw, RNG stream, chain seed."""
    device = keys.device
    b, p = keys.shape[0], cfg.max_particles
    k4 = prng.split(keys, 4)
    hl_key, state_key = k4[:, 2], k4[:, 3]
    st = empty_state(cfg, batch=b, device=device)
    z = torch.full((b,), cfg.z, dtype=torch.int32, device=device)
    n = torch.full((b,), cfg.n, dtype=torch.int32, device=device)
    ptype = torch.from_numpy(_ptype_plan(cfg)).to(device).expand(b, p).clone()
    alive = (torch.arange(p, device=device) < cfg.a).expand(b, p).clone()
    # The chain log opens with the initial isotope (entry 0).
    for name, value in (("chain_z0", cfg.z), ("chain_n0", cfg.n),
                        ("chain_dtype", DECAY_NONE), ("chain_z1", cfg.z),
                        ("chain_n1", cfg.n)):
        getattr(st, name)[:, 0] = value
    return st.replace(
        ptype=ptype,
        alive=alive,
        z=z,
        n=n,
        half_life=tables.half_life(z, n, prng.uniform(hl_key)),
        rng=state_key.contiguous(),
        chain_cursor=torch.ones((b,), dtype=torch.int32, device=device),
    )


def _init_from_key(cfg: SimConfig, keys: torch.Tensor) -> NucleusState:
    """Full exact init of one member per key in ``keys`` (B, 2). Key
    split indices match :func:`_member_identity`."""
    if cfg.a > cfg.max_particles:
        raise ValueError(f"A={cfg.a} exceeds max_particles={cfg.max_particles}")
    place_keys = prng.split(keys, 4)[:, 1]
    st = _member_identity(cfg, keys)
    return st.replace(pos=_place_shells(cfg, place_keys))


def init_state(cfg: SimConfig, seed: int = 0, *, device="cuda") -> NucleusState:
    """One initialised nucleus as a batch of 1 (U-238 by default,
    nuclear_sim.py:90), on ``device`` (the card unless the caller names
    another)."""
    return _init_from_key(cfg, prng.prng_key(seed, device=device)[None])


def ensemble_init(
    cfg: SimConfig,
    batch: int,
    seed: int = 0,
    method: str = "auto",
    pool: int = 256,
    *,
    device="cuda",
) -> NucleusState:
    """A batch of independently seeded nuclei on ``device`` (the card
    unless the caller names another).

    ``method``:
      * ``"exact"`` — every member runs the full sequential best-of-20
        placement;
      * ``"pool"`` — ``pool`` exact placements are built once, then each
        member samples one and rotates it about the nucleus origin by an
        independent random angle;
      * ``"auto"`` — exact when ``batch <= pool``, else pool.

    Either way every member gets an independent PRNG stream and half-life
    draw. The call is the span ``pyqmd.init.ensemble``.
    """
    with annotate("pyqmd.init.ensemble"):
        if method == "auto":
            method = "exact" if batch <= pool else "pool"
        keys = prng.split(prng.prng_key(seed, device=device), batch)
        if method == "exact":
            return _init_from_key(cfg, keys)
        if method != "pool":
            raise ValueError(f"unknown init method {method!r}")

        pool_n = min(pool, batch)
        # Pool geometry comes from the seed+1 stream, independent of members.
        pool_keys = prng.split(prng.prng_key(seed + 1, device=device), pool_n)
        pool_pos = _place_shells(cfg, prng.split(pool_keys, 4)[:, 1])  # (pool_n, P, 2)
        origin = torch.tensor([cfg.origin_x, cfg.origin_y], dtype=torch.float32, device=device)

        k3 = prng.split(keys, 3)
        k_sel, k_rot, k_member = k3[:, 0], k3[:, 1], k3[:, 2]
        i = prng.randint(k_sel, (), 0, pool_n)
        theta = prng.uniform(k_rot, maxval=2.0 * math.pi)
        c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
        rel = pool_pos[i.to(torch.int64)] - origin
        rot = torch.stack(
            [rel[..., 0] * c - rel[..., 1] * s, rel[..., 0] * s + rel[..., 1] * c], dim=-1
        )
        st = _member_identity(cfg, k_member)
        return st.replace(pos=torch.where(st.alive[..., None], origin + rot, origin))


def mixed_ensemble_init(
    cfg: SimConfig, species: list[tuple[int, int, int]], seed: int = 0, *, device="cuda"
) -> NucleusState:
    """A mixed-population batch: ``species`` is a list of ``(Z, N, count)``,
    initialised per species and concatenated in order. Everything downstream
    reads each nucleus's (Z, N) from the state, so one batch can hold
    several isotopes, e.g. U-238 and C-14 decaying side by side, on
    ``device`` (the card unless the caller names another).

    Every species shares ``cfg.max_particles``, so the heaviest must fit;
    only (Z, N) varies per species, and every other field of ``cfg``
    carries through. Species i draws from seed ``seed + i * 1_000_003``.
    """
    parts = []
    for i, (z, n, count) in enumerate(species):
        if z + n > cfg.max_particles:
            raise ValueError(
                f"species ({z},{n}) A={z + n} exceeds max_particles={cfg.max_particles}"
            )
        sub_cfg = dataclasses.replace(cfg, z=z, n=n)
        parts.append(ensemble_init(sub_cfg, count, seed=seed + i * 1_000_003, device=device))
    return NucleusState(**{
        f.name: torch.cat([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(NucleusState)
    })
