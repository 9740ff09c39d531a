"""Wrapper of the CUDA full-physics substep kernel (``csrc/substep.cu``).

:func:`ejecta_decay_substep` is one substep's ejecta and decay for every
nucleus of a full-physics frame: the contract of
:func:`pyqmd_tpu_torch.core.decay.advance_ejecta` followed by
:func:`pyqmd_tpu_torch.core.decay.maybe_decay`, under substep ``s``'s key of
the frame's key tree. CPU tensors take those plain versions; CUDA tensors
launch the kernel, one launch a substep, which updates the state's tensors
in place, or the call raises. The kernel
replaces no TPU kernel: the JAX package leaves this part of its frame to
XLA.
"""

from __future__ import annotations

import ctypes

import torch

from pyqmd_tpu_torch import prng
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import decay as _decay
from pyqmd_tpu_torch.core.dynamics import FrameScalars
from pyqmd_tpu_torch.data import tables
from pyqmd_tpu_torch.kernels import _build
from pyqmd_tpu_torch.state import NUM_DECAY_TYPES, NucleusState
from pyqmd_tpu_torch.utils.profiling import count

# The state fields a substep writes, in the order of PqSubstepFields; it
# also reads pos and time_passed. On the card it writes them in place.
SUBSTEP_FIELDS = (
    "vel", "alive", "ptype", "z", "n", "half_life", "decay_counts", "last_decay_time",
    "chain_z0", "chain_n0", "chain_dtype", "chain_z1", "chain_n1", "chain_time", "chain_cursor",
    "ej_pos", "ej_vel", "ej_type", "ej_age", "ej_life", "ej_alive", "ej_cursor",
)

_PTR = ctypes.c_void_p


class _Fields(ctypes.Structure):
    """Mirror of ``PqSubstepFields``."""

    _fields_ = [(f, _PTR) for f in SUBSTEP_FIELDS]


class _Args(ctypes.Structure):
    """Mirror of ``PqSubstepArgs``."""

    _fields_ = [
        ("f", _Fields), ("pos", _PTR), ("time_passed", _PTR), ("k3", _PTR),
        ("rows", _PTR), ("step_time", _PTR), ("anim_step", _PTR), ("nucleon_step", _PTR),
        ("anim_age_inc", _PTR), ("ejecta_life", _PTR), ("batch", ctypes.c_int64),
        ("particles", ctypes.c_int32), ("ejecta", ctypes.c_int32), ("chain", ctypes.c_int32),
        ("per_event", ctypes.c_int32), ("step", ctypes.c_int32),
        ("fast_lifetimes", ctypes.c_int32),
        ("decay_damping", ctypes.c_float),
    ]


def ejecta_decay_substep(states: NucleusState, cfg: SimConfig, sc: FrameScalars,
                         k3: torch.Tensor, s: int) -> NucleusState:
    """Substep ``s`` of a full-physics frame before its force step: the
    ejecta advance, then the decay check under the substep key
    ``split(k3[:, 0], S)[:, s]`` (any ``S > s``), ``k3 = split(rng, 3)``
    (B, 3, 2) the frame's key split. ``sc`` holds the frame's scalars,
    ``states.time_passed`` the frame clock. Returns the new state.

    On CUDA tensors the kernel updates the fields of :data:`SUBSTEP_FIELDS`
    in their tensors and returns ``states``: a caller that still needs the
    input clones those fields first, as ``core.step.frame_body`` does once
    a frame. On CPU tensors the plain version returns new tensors.
    """
    dev = states.z.device
    if dev.type == "cpu":
        # Key s of split(k, S) hashes counter (0, s), as fold_in(k, s) does.
        keys = prng.fold_in(k3[:, 0], s)
        return _decay.maybe_decay(_decay.advance_ejecta(states, cfg, sc), cfg, keys, sc)[0]
    if dev.type != "cuda":
        raise ValueError(f"ejecta_decay_substep runs on CPU or CUDA tensors, not {dev}")
    _check(states, k3, sc)
    b, p = states.alive.shape
    args = _Args(
        f=_fields(states), pos=states.pos.data_ptr(),
        time_passed=states.time_passed.data_ptr(), k3=k3.data_ptr(),
        rows=tables.rows_on(dev).data_ptr(), step_time=sc.step_time.data_ptr(),
        anim_step=sc.anim_step.data_ptr(), nucleon_step=sc.nucleon_step.data_ptr(),
        anim_age_inc=sc.anim_age_inc.data_ptr(), ejecta_life=sc.ejecta_life.data_ptr(),
        batch=b, particles=p, ejecta=states.ej_type.shape[1],
        chain=states.chain_time.shape[1], per_event=cfg.max_ejecta_per_event, step=s,
        fast_lifetimes=int(sc.fast_lifetimes), decay_damping=cfg.decay_damping,
    )
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.pyqmd_ejecta_decay_substep(ctypes.addressof(args),
                                             torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error(err, "ejecta and decay substep")
    count("kernels.ejecta_decay_substep.launches")
    return states


def _fields(states: NucleusState) -> _Fields:
    return _Fields(*(getattr(states, f).data_ptr() for f in SUBSTEP_FIELDS))


def _check(states: NucleusState, k3: torch.Tensor, sc: FrameScalars) -> None:
    """Raise unless the state, keys and scalars are what the kernel takes:
    on one CUDA device, the listed dtypes and shapes, contiguous."""
    dev = states.z.device
    b, p = states.alive.shape
    e = states.ej_type.shape[1]
    c = states.chain_time.shape[1]
    if e < 1 or c < 1:
        raise ValueError(f"needs at least one ejecta and one chain slot, got E={e}, C={c}")
    i32, f32 = (torch.int32,), (torch.float32,)
    bools = (torch.bool, torch.uint8)
    shapes = {
        "pos": (f32, (b, p, 2)), "vel": (f32, (b, p, 2)), "alive": (bools, (b, p)),
        "ptype": (i32, (b, p)), "decay_counts": (i32, (b, NUM_DECAY_TYPES)),
        "ej_pos": (f32, (b, e, 2)), "ej_vel": (f32, (b, e, 2)), "ej_type": (i32, (b, e)),
        "ej_age": (f32, (b, e)), "ej_life": (f32, (b, e)), "ej_alive": (bools, (b, e)),
    }
    for name in ("z", "n", "chain_cursor", "ej_cursor"):
        shapes[name] = (i32, (b,))
    for name in ("half_life", "time_passed", "last_decay_time"):
        shapes[name] = (f32, (b,))
    for name in ("chain_z0", "chain_n0", "chain_dtype", "chain_z1", "chain_n1"):
        shapes[name] = (i32, (b, c))
    shapes["chain_time"] = (f32, (b, c))
    for name, (dtypes, shape) in shapes.items():
        _build.check_tensor(getattr(states, name), name, dtypes, shape, dev)
    _build.check_tensor(k3, "k3", (torch.int64,), (b, 3, 2), dev)
    for name in ("step_time", "anim_step", "nucleon_step", "anim_age_inc", "ejecta_life"):
        t = getattr(sc, name)
        if t.device != dev or t.dtype != torch.float32 or t.dim() != 0:
            raise ValueError(f"the frame scalar {name} must be a 0-d f32 tensor on {dev}")
