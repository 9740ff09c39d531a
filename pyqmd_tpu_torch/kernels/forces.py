"""Wrapper of the CUDA force + integrate kernels (``csrc/forces.cu`` and
``csrc/forces_small.cu``).

:func:`force_step` has the contract of
:func:`pyqmd_tpu_torch.core.forces.force_step`. CPU tensors take that plain
version; CUDA tensors launch a kernel, or the call raises. The capacity P
alone picks the kernel: P <= 32 the small-nucleus kernel (a group of
next_pow2(P) lanes per nucleus, replacing ``_force_kernel_packed`` of
``pyqmd_tpu/kernels/forces_pallas.py``), above that the tiled kernel (a
block per nucleus, replacing ``_force_kernel``). Neither stands in for the
other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import forces as _plain
from pyqmd_tpu_torch.kernels import _build
from pyqmd_tpu_torch.utils.profiling import count

# The kernel takes up to 64 tiles of 32 slots; at P = 2000 its slots and
# per-warp force buffers take 161 KB of shared memory, which it opts into.
MAX_PARTICLES = 2000
# The small-nucleus kernel's capacities: a nucleus within one warp.
SMALL_MAX_PARTICLES = 32


class ForceParams(ctypes.Structure):
    """Mirror of ``PqForceParams`` in ``csrc/pair_math.cuh``."""

    _fields_ = [
        (name, ctypes.c_float)
        for name in (
            "hard_core_strength", "min_allowed", "strong_amp_attract",
            "strong_amp_tail", "strong_core_amp", "epsilon", "strong_range",
            "strong_attract_cut", "strong_core_cut", "coulomb_strength",
            "pauli_strength", "pauli_range", "max_pair_force", "com_spring",
            "damping", "inv_min_allowed", "inv_strong_range", "inv_pauli_range",
        )
    ] + [("leapfrog", ctypes.c_int32), ("fast_math", ctypes.c_int32)]


def force_params(cfg: SimConfig) -> ForceParams:
    """The kernel's constants, folded in float64 as the plain version's
    Python expressions fold them, then rounded to f32 by ctypes."""
    s = cfg.strong_strength
    min_allowed = cfg.nucleon_radius * cfg.hard_core_scale
    return ForceParams(
        hard_core_strength=cfg.hard_core_strength,
        min_allowed=min_allowed,
        strong_amp_attract=1.25 * s,
        strong_amp_tail=0.15 * s,
        strong_core_amp=-0.7 * s,
        epsilon=cfg.epsilon,
        strong_range=cfg.strong_range,
        strong_attract_cut=cfg.strong_attract_cut,
        strong_core_cut=cfg.strong_core_cut,
        coulomb_strength=cfg.coulomb_strength,
        pauli_strength=cfg.pauli_strength,
        pauli_range=cfg.pauli_range,
        max_pair_force=cfg.max_pair_force,
        com_spring=cfg.com_spring,
        damping=cfg.damping,
        inv_min_allowed=1.0 / min_allowed,
        inv_strong_range=1.0 / cfg.strong_range,
        inv_pauli_range=1.0 / cfg.pauli_range,
        leapfrog=int(cfg.integrator == "leapfrog"),
        fast_math=int(cfg.fast_math),
    )


def force_step(pos, vel, ptype, alive, dt, cfg: SimConfig):
    """One force + integrate substep: pos/vel (B, P, 2) f32, ptype (B, P)
    int32, alive (B, P) bool or uint8, ``dt`` a float or a 0-d f32 tensor
    on their device, which the kernel reads from device memory (so that a
    CUDA graph of the launch reads each replay's dt). Returns new (pos,
    vel)."""
    if pos.device.type == "cpu":
        return _plain.force_step(pos, vel, ptype, alive, dt, cfg)
    if pos.device.type != "cuda":
        raise ValueError(f"force_step runs on CPU or CUDA tensors, not {pos.device}")
    b, p = ptype.shape[:2]
    if p > MAX_PARTICLES:
        raise ValueError(f"P={p} exceeds the kernel's {MAX_PARTICLES} particles")
    f32 = (torch.float32,)
    _build.check_tensor(pos, "pos", f32, (b, p, 2), pos.device)
    _build.check_tensor(vel, "vel", f32, (b, p, 2), pos.device)
    _build.check_tensor(ptype, "ptype", (torch.int32,), (b, p), pos.device)
    _build.check_tensor(alive, "alive", (torch.bool, torch.uint8), (b, p), pos.device)
    if isinstance(dt, torch.Tensor):
        _build.check_tensor(dt, "dt", f32, (), pos.device)
    else:
        dt = torch.full((), float(dt), dtype=torch.float32, device=pos.device)
    lib = _build.library()
    small = p <= SMALL_MAX_PARTICLES
    entry = lib.pyqmd_force_step_small if small else lib.pyqmd_force_step
    out_pos = torch.empty_like(pos)
    out_vel = torch.empty_like(vel)
    params = force_params(cfg)
    with torch.cuda.device(pos.device):
        err = entry(
            pos.data_ptr(), vel.data_ptr(), ptype.data_ptr(), alive.data_ptr(),
            out_pos.data_ptr(), out_vel.data_ptr(), b, p, dt.data_ptr(),
            ctypes.addressof(params), torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error(err, "small force" if small else "force")
    count("kernels.force_step.launches")
    if small:
        count("kernels.force_step.small_launches")
    elif schedule(p)[1] > 0:
        count("kernels.force_step.paired_launches")
    return out_pos, out_vel


@functools.cache
def schedule(p: int) -> tuple[int, int, int]:
    """The tiled kernel's schedule at capacity ``p`` as the library makes
    it (``csrc/pair_tiles.cuh:pq_force_launch``): (jobs, paired jobs,
    warps a block). Paired jobs, two rows a lane against one partner,
    exist from 65 slots (three tiles) on."""
    jobs, paired, warps = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _build.library().pyqmd_force_schedule(p, ctypes.byref(jobs), ctypes.byref(paired),
                                                ctypes.byref(warps))
    if err:
        raise ValueError(f"the force kernel takes no P={p}")
    return jobs.value, paired.value, warps.value
