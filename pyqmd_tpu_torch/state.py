"""Batched struct-of-arrays simulation state.

Every field of :class:`NucleusState` is a tensor whose leading dim is the
ensemble batch ``B`` (a single nucleus is ``B = 1``). Particle and decay
types are plain ints (particles.py:5-21).

The PRNG key ``rng`` is the JAX package's ``(B, 2) uint32`` raw key data
carried as ``int64`` masked to 32 bits: torch's CPU ``uint32`` lacks
``+``, ``<<`` and ``>>``, which the threefry hash needs
(:mod:`pyqmd_tpu_torch.prng`). :func:`state_from_numpy` and
:func:`state_to_numpy` map it exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.prng import prng_key

# ParticleType (particles.py:5-11)
PROTON = 0
NEUTRON = 1
ALPHA = 2
ELECTRON = 3
GAMMA = 4
POSITRON = 5
NUM_PARTICLE_TYPES = 6

PARTICLE_TYPE_NAMES = ["PROTON", "NEUTRON", "ALPHA", "ELECTRON", "GAMMA", "POSITRON"]

# DecayType (particles.py:13-21)
DECAY_NONE = 0
DECAY_ALPHA = 1
DECAY_BETA_MINUS = 2
DECAY_BETA_PLUS = 3
DECAY_GAMMA = 4
DECAY_NEUTRON_EMISSION = 5
DECAY_PROTON_EMISSION = 6
DECAY_SPONTANEOUS_FISSION = 7
NUM_DECAY_TYPES = 8

DECAY_TYPE_NAMES = [
    "NONE",
    "ALPHA",
    "BETA_MINUS",
    "BETA_PLUS",
    "GAMMA",
    "NEUTRON_EMISSION",
    "PROTON_EMISSION",
    "SPONTANEOUS_FISSION",
]

# Decay symbols (nuclear_sim.py:548-559)
DECAY_SYMBOLS = ["-", "α", "β-", "β+", "γ", "n", "p", "SF"]

# Particle display radius (particles.py:30): nucleons 2.5, ejecta 1.0.
NUCLEON_RADIUS = 2.5
EJECTA_RADIUS = 1.0

# Base ejecta lifetimes by particle type (particles.py:31-38).
BASE_LIFETIMES = np.array([np.inf, np.inf, 2.0, 3.0, 1.0, 3.0], dtype=np.float32)

# Post-decay ejecta speed by particle type (nuclear_sim.py:296-313).
EJECTA_SPEEDS = np.array([40.0, 40.0, 30.0, 50.0, 60.0, 50.0], dtype=np.float32)

_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class NucleusState:
    """State of a batch of nuclei and their ejecta pools.

    Nucleon arrays are padded to ``cfg.max_particles`` with ``alive``
    masks; ejecta live in a fixed ring of ``cfg.max_ejecta`` slots.
    Shapes below omit the leading batch dim ``B``.
    """

    # Nucleons (the particles the force kernel acts on).
    pos: torch.Tensor  # (P, 2) f32
    vel: torch.Tensor  # (P, 2) f32
    ptype: torch.Tensor  # (P,) i32 — PROTON or NEUTRON
    alive: torch.Tensor  # (P,) bool

    # Nuclear identity.
    z: torch.Tensor  # () i32 protons
    n: torch.Tensor  # () i32 neutrons
    half_life: torch.Tensor  # () f32 seconds; +inf = stable

    # Ejecta ring buffer.
    ej_pos: torch.Tensor  # (E, 2) f32
    ej_vel: torch.Tensor  # (E, 2) f32
    ej_type: torch.Tensor  # (E,) i32
    ej_age: torch.Tensor  # (E,) f32
    ej_life: torch.Tensor  # (E,) f32
    ej_alive: torch.Tensor  # (E,) bool
    ej_cursor: torch.Tensor  # () i32 next write slot

    # Threefry key data, uint32 words carried as int64.
    rng: torch.Tensor  # (2,) int64

    decay_counts: torch.Tensor  # (NUM_DECAY_TYPES,) i32

    # Simulation clock and the time of the last decay (nuclear_sim.py:54,
    # 113, 124, 281).
    time_passed: torch.Tensor  # () f32
    last_decay_time: torch.Tensor  # () f32

    # Decay-chain event log ring (nuclear_sim.py:271-278). Entry i % L:
    # parent (Z, N), decay type, daughter (Z, N), duration.
    chain_z0: torch.Tensor  # (L,) i32
    chain_n0: torch.Tensor  # (L,) i32
    chain_dtype: torch.Tensor  # (L,) i32
    chain_z1: torch.Tensor  # (L,) i32
    chain_n1: torch.Tensor  # (L,) i32
    chain_time: torch.Tensor  # (L,) f32
    chain_cursor: torch.Tensor  # () i32 — total entries ever written

    @property
    def batch(self) -> int:
        return self.pos.shape[0]

    def replace(self, **kw) -> "NucleusState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "NucleusState":
        return NucleusState(
            **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )

    def alive_count(self) -> torch.Tensor:
        return self.alive.to(torch.int32).sum(-1, dtype=torch.int32)

    def center_of_mass(self) -> torch.Tensor:
        """Mean position of alive nucleons (particles.py:205-208)."""
        w = self.alive.to(self.pos.dtype)
        cnt = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
        return (self.pos * w[..., None]).sum(-2) / cnt

    def kinetic_energy(self) -> torch.Tensor:
        """Total kinetic energy of alive nucleons, ½Σ|v|² (unit masses)."""
        w = self.alive.to(self.vel.dtype)
        return 0.5 * ((self.vel * self.vel).sum(-1) * w).sum(-1)

    def rms_radius(self) -> torch.Tensor:
        """RMS distance of alive nucleons from the center of mass."""
        w = self.alive.to(self.pos.dtype)
        cnt = torch.clamp(w.sum(-1), min=1.0)
        d2 = ((self.pos - self.center_of_mass()[..., None, :]) ** 2).sum(-1)
        return torch.sqrt((d2 * w).sum(-1) / cnt)


def empty_state(
    cfg: SimConfig, seed: int = 0, *, batch: int = 1, device="cuda"
) -> NucleusState:
    """All-dead batch with the right shapes and dtypes (no placement), on
    ``device`` (the card unless the caller names another)."""
    p, e, l = cfg.max_particles, cfg.max_ejecta, cfg.max_chain_log
    f32, i32 = torch.float32, torch.int32

    def zeros(*shape, dtype):
        return torch.zeros((batch, *shape), dtype=dtype, device=device)

    def full(*shape, value, dtype):
        return torch.full((batch, *shape), value, dtype=dtype, device=device)

    return NucleusState(
        pos=zeros(p, 2, dtype=f32),
        vel=zeros(p, 2, dtype=f32),
        ptype=zeros(p, dtype=i32),
        alive=zeros(p, dtype=torch.bool),
        z=zeros(dtype=i32),
        n=zeros(dtype=i32),
        half_life=full(value=float("inf"), dtype=f32),
        ej_pos=zeros(e, 2, dtype=f32),
        ej_vel=zeros(e, 2, dtype=f32),
        ej_type=zeros(e, dtype=i32),
        ej_age=zeros(e, dtype=f32),
        ej_life=full(e, value=float("inf"), dtype=f32),
        ej_alive=zeros(e, dtype=torch.bool),
        ej_cursor=zeros(dtype=i32),
        rng=prng_key(seed, device=device).expand(batch, 2).clone(),
        decay_counts=zeros(NUM_DECAY_TYPES, dtype=i32),
        time_passed=zeros(dtype=f32),
        last_decay_time=zeros(dtype=f32),
        chain_z0=zeros(l, dtype=i32),
        chain_n0=zeros(l, dtype=i32),
        chain_dtype=zeros(l, dtype=i32),
        chain_z1=zeros(l, dtype=i32),
        chain_n1=zeros(l, dtype=i32),
        chain_time=zeros(l, dtype=f32),
        chain_cursor=zeros(dtype=i32),
    )


def state_from_numpy(arrays: dict, device="cuda") -> NucleusState:
    """Build a state on ``device`` (the card unless the caller names
    another) from ``{field: ndarray}`` with the JAX package's dtypes
    (``rng`` as uint32). Arrays must already carry the batch dim."""
    fields = {}
    for f in dataclasses.fields(NucleusState):
        a = np.asarray(arrays[f.name])
        if f.name == "rng":
            a = a.astype(np.uint32).astype(np.int64)
        fields[f.name] = torch.from_numpy(np.array(a)).to(device)  # own copy
    return NucleusState(**fields)


def state_to_numpy(state: NucleusState) -> dict:
    """Inverse of :func:`state_from_numpy`: ``rng`` back to uint32."""
    out = {}
    for f in dataclasses.fields(state):
        a = getattr(state, f.name).detach().cpu().numpy()
        if f.name == "rng":
            a = (a & _U32).astype(np.uint32)
        out[f.name] = a
    return out
