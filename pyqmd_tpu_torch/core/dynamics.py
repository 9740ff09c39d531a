"""Per-frame scalars shared by every substep of a frame.

The JAX package carries these as f32 device scalars; here they are
``np.float32`` host scalars, so the frame's scalar arithmetic rounds in
f32 in the same order as the reference without a device round trip. Code
that combines one with a tensor passes it as ``float(...)``, which is
exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
    """

    time_scale: np.float32
    substeps: np.float32
    physics_dt: np.float32
    step_time: np.float32
    raw_physics_dt: np.float32 | None = None
