"""Per-frame scalars shared by every substep of a frame.

The JAX package carries these as f32 device scalars. Here the host
computes each one as an ``np.float32``, so the frame's scalar arithmetic
rounds in f32 in the same order as the reference: :class:`FrameDynamics`
holds the frame's inputs, and :func:`scalar_values` derives every f32
value the full-physics frame reads from them.

Those values reach the tensor ops as :class:`FrameScalars`, 0-d views of
one f32 vector on the state's device, written once per frame without a
synchronisation. No value of the frame is baked into an op, so a frame
captured in a CUDA graph (:mod:`pyqmd_tpu_torch.core.graphs`) replays at
any time scale, frame interval and physics dt: a new frame only rewrites
the vector. The one branch on a value, the ejecta lifetime's ``ts > 1``
regime, is a host flag that the graphs put into their key.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.config import SimConfig

_F32 = np.float32


class FrameDynamics(NamedTuple):
    """Frame scalars, each an ``np.float32``.

    time_scale  — sim-seconds per wall-second (nuclear_sim.py:50).
    substeps    — substep count this frame (nuclear_sim.py:153-154).
    physics_dt  — effective physics timestep (nuclear_sim.py:145).
    step_time   — sim-seconds per substep = frame_dt*time_scale/substeps
                  (nuclear_sim.py:165): the decay-Bernoulli and ejecta
                  aging dt.
    raw_physics_dt — the unscaled physics timestep (nuclear_sim.py:59)
                  that the ejecta-lifetime dt factor reads
                  (nuclear_sim.py:327); ``None`` means ``physics_dt``.
    desired_dt  — sim-seconds per frame = frame_dt*time_scale, the clock's
                  advance (nuclear_sim.py:124); ``None`` where no clock
                  reads it.
    """

    time_scale: np.float32
    substeps: np.float32
    physics_dt: np.float32
    step_time: np.float32
    raw_physics_dt: np.float32 | None = None
    desired_dt: np.float32 | None = None


def frame_dynamics(cfg: SimConfig, time_scale, frame_dt, num_steps: int, physics_dt,
                   raw_physics_dt) -> FrameDynamics:
    """The frame's :class:`FrameDynamics` from its call arguments
    (``physics_dt=None`` is the config's effective dt)."""
    time_scale = _F32(time_scale)
    desired_dt = _F32(frame_dt) * time_scale
    if physics_dt is None:
        physics_dt = cfg.effective_dt()
    return FrameDynamics(
        time_scale=time_scale,
        substeps=_F32(num_steps),
        physics_dt=_F32(physics_dt),
        step_time=desired_dt / _F32(num_steps),
        raw_physics_dt=None if raw_physics_dt is None else _F32(raw_physics_dt),
        desired_dt=desired_dt,
    )


# The f32 values of FrameScalars, in the order of its vector.
SCALAR_NAMES = ("desired_dt", "physics_dt", "step_time", "anim_step", "nucleon_step",
                "anim_age_inc", "ejecta_life")


class FrameScalars(NamedTuple):
    """Every f32 scalar of a full-physics frame as a 0-d view of ``vec``.

    desired_dt   — the clock's advance (NaN where the dynamics carry none).
    physics_dt   — the force step's dt.
    step_time    — the decay Bernoulli interval and the nucleon ejecta's
                   age increment.
    anim_step    — the animated ejecta's advection step.
    nucleon_step — the emitted nucleons' advection step.
    anim_age_inc — the animated ejecta's age increment.
    ejecta_life  — a new fragment's lifetime where ``fast_lifetimes``,
                   else the floor of the per-type base lifetimes.
    fast_lifetimes — the ``ts > 1`` regime of the lifetime (host flag).
    """

    vec: torch.Tensor
    desired_dt: torch.Tensor
    physics_dt: torch.Tensor
    step_time: torch.Tensor
    anim_step: torch.Tensor
    nucleon_step: torch.Tensor
    anim_age_inc: torch.Tensor
    ejecta_life: torch.Tensor
    fast_lifetimes: bool

    @classmethod
    def views(cls, vec: torch.Tensor, fast_lifetimes: bool) -> "FrameScalars":
        """The scalars as views of ``vec`` (len(SCALAR_NAMES),) f32."""
        return cls(vec, *vec.unbind(0), fast_lifetimes=bool(fast_lifetimes))


def scalar_values(dyn: FrameDynamics, cfg: SimConfig) -> tuple[np.ndarray, bool]:
    """Every f32 value of :class:`FrameScalars`, computed on the host with
    the reference's f32 expressions, and the lifetime regime."""
    ts, ss = dyn.time_scale, dyn.substeps
    # Animated decay products move at a fixed animation step with
    # substep-compensated speed; the reference folds the two config
    # constants in float64 first (nuclear_sim.py:178-210).
    substep_factor = _F32(10.0) / np.maximum(_F32(1.0), ss)
    anim_step = _F32((cfg.animation_dt * cfg.ejecta_speed_scale) * substep_factor)
    nucleon_step = dyn.physics_dt * np.sqrt(ts)
    aging_scale = np.minimum(
        _F32(1.0),
        _F32(1.0)
        / (np.sqrt(np.maximum(_F32(1.0), ts / _F32(100.0)))
           * np.sqrt(np.maximum(_F32(1.0), ss / _F32(10.0)))),
    )
    anim_age_inc = dyn.step_time * aging_scale

    # Ejecta lifetime with the reference's time-scale/substep/dt
    # compensation (nuclear_sim.py:315-342); the dt factor reads the raw
    # physics dt (nuclear_sim.py:327).
    base = cfg.base_ejecta_lifetime
    pdt = dyn.raw_physics_dt if dyn.raw_physics_dt is not None else dyn.physics_dt
    fast_lifetimes = bool(ts > 1.0)
    if fast_lifetimes:
        tf = np.maximum(_F32(1.0), ts / _F32(100.0))
        sf = np.maximum(_F32(1.0), np.sqrt(ss))
        df = np.maximum(_F32(1.0), _F32(0.016) / pdt)
        life = np.maximum(base * sf, base * tf * sf * df)
        if ss > 15.0:
            life = life * (ss / _F32(15.0))
    else:
        # Slow/real-time branch: at least the per-type base lifetime.
        life = base * np.maximum(_F32(1.0), ss / _F32(5.0))

    desired = np.nan if dyn.desired_dt is None else dyn.desired_dt
    values = np.array([desired, dyn.physics_dt, dyn.step_time, anim_step, nucleon_step,
                       anim_age_inc, life], dtype=np.float32)
    return values, fast_lifetimes


def host_scalars(values: np.ndarray, device) -> torch.Tensor:
    """``values`` as a CPU tensor to copy to ``device``: in pinned memory
    for the card, so that the copy does not wait. PyTorch's pinned-memory
    cache hands the block out again only after the copy has run."""
    host = torch.from_numpy(values)
    return host.pin_memory() if torch.device(device).type == "cuda" else host


def scalars_to_device(values: np.ndarray, device) -> torch.Tensor:
    """``values`` as a new f32 tensor on ``device``, copied without a
    synchronisation."""
    return host_scalars(values, device).to(device, non_blocking=True)


def frame_scalars(dyn: FrameDynamics, cfg: SimConfig, device) -> FrameScalars:
    """The frame's :class:`FrameScalars` on ``device``."""
    values, fast = scalar_values(dyn, cfg)
    return FrameScalars.views(scalars_to_device(values, device), fast)


def as_scalars(dyn, cfg: SimConfig, device) -> FrameScalars:
    """``dyn`` itself if it is :class:`FrameScalars`; a
    :class:`FrameDynamics` is written to ``device`` first."""
    if isinstance(dyn, FrameScalars):
        return dyn
    return frame_scalars(dyn, cfg, device)
