"""Static simulation configuration for the PyTorch port.

Same fields, defaults and checks as ``pyqmd_tpu.config.SimConfig`` minus
the two backend selectors: in the port the tensor's device decides. CPU
tensors take the plain PyTorch version of each kernel; CUDA tensors take
the hand-written kernel, or the call raises.
"""

from __future__ import annotations

import dataclasses

# Keys of the JAX config that the port has no counterpart for.
_DROPPED_KEYS = ("force_backend", "decay_backend")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Frozen, hashable simulation configuration.

    Force-law constants mirror the reference OpenCL kernel
    (nuclear_forces.py:13-15, 58, 82-83, 102-154) and host wrapper.
    """

    # Initial isotope (reference default U-238: nuclear_sim.py:90).
    z: int = 92
    n: int = 146

    # Padded capacity of the nucleon arrays: decays mask particles out
    # instead of shrinking lists (particles.py:181-198).
    max_particles: int = 256
    # Ejecta ring-buffer capacity per nucleus.
    max_ejecta: int = 64
    # Decay-chain event-log ring capacity (nuclear_sim.py:271-278).
    max_chain_log: int = 64
    # Ejecta slots written per decay event (fission emits 2-3 fragments,
    # decay_chains.py:373-388; every other mode emits 1).
    max_ejecta_per_event: int = 3

    # Integration (nuclear_sim.py:59, 63, 62, 66).
    physics_dt: float = 1.0 / 240.0
    max_substeps: int = 20
    accuracy: float = 1.0  # effective dt = physics_dt * (2 - accuracy)
    physics_dt_factor: float = 0.8  # auto-adjust scale (nuclear_sim.py:66)

    # Approximate reciprocals inside the CUDA force kernel — the analog of
    # the reference's -cl-fast-relaxed-math build flag
    # (nuclear_forces.py:175), which is also its default. The plain
    # PyTorch version always divides exactly.
    fast_math: bool = True

    # Force strengths (nuclear_forces.py:13-15).
    strong_strength: float = 150.0
    coulomb_strength: float = 30.0
    pauli_strength: float = 35.0

    # Kernel constants (nuclear_forces.py:58, 82-83, 102, 109, 131, 144-154).
    epsilon: float = 0.15
    nucleon_radius: float = 2.5
    max_pair_force: float = 12.0
    hard_core_scale: float = 1.7  # min allowed dist = radius * 1.7
    hard_core_strength: float = 60.0
    strong_range: float = 7.0
    strong_core_cut: float = 2.8
    strong_attract_cut: float = 9.0
    pauli_range: float = 8.0
    com_spring: float = 0.03

    # Velocity damping each force step (nuclear_forces.py:161-162) and on
    # decay (particles.py:200-203).
    damping: float = 0.85
    decay_damping: float = 0.8

    # "euler" is the reference's semi-implicit Euler
    # (nuclear_forces.py:156-171); "leapfrog" is kick-drift-kick with two
    # force evaluations per step.
    integrator: str = "euler"

    # Overlap resolution (nuclear_sim.py:355-379).
    overlap_min_dist: float = 5.0
    overlap_iterations: int = 1

    # Ejecta animation (nuclear_sim.py:178-203, 316).
    animation_dt: float = 1.0 / 240.0
    ejecta_speed_scale: float = 0.3
    base_ejecta_lifetime: float = 5.0

    # World-space spawn point of the nucleus (nuclear_sim.py:93).
    origin_x: float = 400.0
    origin_y: float = 400.0

    def __post_init__(self):
        if self.z + self.n > self.max_particles:
            raise ValueError(
                f"A={self.z + self.n} exceeds max_particles={self.max_particles}"
            )
        if self.integrator not in ("euler", "leapfrog"):
            raise ValueError(f"unknown integrator {self.integrator!r}")
        if not self.physics_dt > 0.0:
            raise ValueError(f"physics_dt must be > 0, got {self.physics_dt}")
        if not 0.0 <= self.accuracy < 2.0:
            # effective_dt() = physics_dt * (2 - accuracy) must stay > 0.
            raise ValueError(
                f"accuracy must be in [0, 2), got {self.accuracy}"
            )
        if self.max_substeps < 1:
            raise ValueError(
                f"max_substeps must be >= 1, got {self.max_substeps}"
            )

    @property
    def a(self) -> int:
        """Mass number of the initial isotope."""
        return self.z + self.n

    @classmethod
    def for_isotope(cls, z: int, n: int, *, pad_to: int = 8, **kw) -> "SimConfig":
        """Config sized for one isotope, padding capacity to a multiple of
        ``pad_to``."""
        cap = max(pad_to, _round_up(z + n, pad_to))
        return cls(z=z, n=n, max_particles=cap, **kw)

    def effective_dt(self) -> float:
        """Effective physics timestep (nuclear_sim.py:145)."""
        return self.physics_dt * (2.0 - self.accuracy)

    def num_substeps(self, frame_dt: float, time_scale: float) -> int:
        """Substep count for one frame (nuclear_sim.py:153)."""
        desired = frame_dt * time_scale
        return max(1, min(self.max_substeps, int(desired / self.effective_dt())))


def config_from_dict(d: dict) -> SimConfig:
    """Build a port config from ``dataclasses.asdict`` of a JAX config,
    dropping the backend selectors the port does not have."""
    return SimConfig(**{k: v for k, v in d.items() if k not in _DROPPED_KEYS})
