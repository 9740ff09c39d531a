"""Wrapper of the CUDA decay-statistics kernel (``csrc/decay.cu``).

:func:`decay_stats_frame` runs a whole statistics frame for every nucleus,
in place on the frame's carry, its substep keys derived in the kernel from
the members' frame keys. CPU tensors take the plain version,
:func:`_plain_substep` once per substep under the frame's key tree
built by :mod:`pyqmd_tpu_torch.prng`; CUDA tensors launch the kernel, or
the call raises. The kernel replaces ``pyqmd_tpu/kernels/decay_pallas.py``
``_decay_stats_kernel`` and the JAX frame's scan over it.
"""

from __future__ import annotations

import torch

from pyqmd_tpu_torch import prng
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import decay as _plain
from pyqmd_tpu_torch.core.dynamics import FrameDynamics
from pyqmd_tpu_torch.data import tables
from pyqmd_tpu_torch.kernels import _build
from pyqmd_tpu_torch.state import NUM_DECAY_TYPES, NucleusState
from pyqmd_tpu_torch.utils.profiling import count

# The state fields a substep writes (it also reads time_passed).
DECAY_FIELDS = (
    "z", "n", "chain_cursor", "half_life", "last_decay_time", "decay_counts",
    "chain_z0", "chain_n0", "chain_dtype", "chain_z1", "chain_n1", "chain_time",
)


def _plain_substep(
    state: NucleusState, bits: tuple, cfg: SimConfig, keys: torch.Tensor, dyn: FrameDynamics
) -> None:
    """One statistics-only decay substep, in place, in plain PyTorch: the
    plain :func:`pyqmd_tpu_torch.core.decay.maybe_decay` with
    ``stats_only=True`` and ``packed_nucleons``, its result copied into the
    carry. :func:`decay_stats_frame` runs it on CPU tensors, and the tests
    hold the kernel to it.

    ``state``'s :data:`DECAY_FIELDS` and ``bits = (alive_bits,
    proton_bits)``, (B, W) int64 words of :func:`pack_nucleon_bits
    <pyqmd_tpu_torch.core.decay.pack_nucleon_bits>`, are updated; ``keys``
    (B, 2) int64 are the nuclei's substep keys and ``dyn.step_time`` the
    Bernoulli interval. Positions, velocities, ejecta and ``state.alive`` /
    ``state.ptype`` are neither read nor written.
    """
    new, _, new_bits = _plain.maybe_decay(
        state, cfg, keys, dyn, stats_only=True, packed_nucleons=bits
    )
    for f in DECAY_FIELDS:
        getattr(state, f).copy_(getattr(new, f))
    for old, nb in zip(bits, new_bits):
        old.copy_(nb)


def decay_stats_frame(
    state: NucleusState, bits: tuple, rng: torch.Tensor, cfg: SimConfig, dyn: FrameDynamics,
    num_steps: int,
) -> torch.Tensor:
    """A statistics-only frame of ``num_steps`` substeps, in place; returns
    the next rng.

    ``state``, ``bits`` and ``dyn`` are as for :func:`_plain_substep`,
    with ``state.time_passed`` the frame clock, already advanced: every
    substep reads it. ``rng`` (B, 2) int64 are the members' frame keys; they
    are only read. Substep s runs under ``split(split(rng, 3)[:, 0],
    num_steps)[:, s]`` and the result is ``split(rng, 3)[:, 2]``, a new
    tensor: the frame's key tree of :func:`core.step.ensemble_step
    <pyqmd_tpu_torch.core.step.ensemble_step>`, which the kernel derives
    per nucleus without storing it.
    """
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    dev = state.z.device
    if dev.type == "cpu":
        k3 = prng.split(rng, 3)  # (B, 3, 2)
        step_keys = prng.split(k3[:, 0], num_steps).transpose(0, 1).contiguous()  # (S, B, 2)
        for keys in step_keys:
            _plain_substep(state, bits, cfg, keys, dyn)
        return k3[:, 2].contiguous()
    _check_carry(state, bits, "decay_stats_frame")
    b = state.z.shape[0]
    _build.check_tensor(rng, "rng", (torch.int64,), (b, 2), dev)
    rows = tables.rows_on(dev)
    lib = _build.library()
    next_rng = torch.empty_like(rng)
    with torch.cuda.device(dev):
        err = lib.pyqmd_decay_stats_frame(
            *_carry_ptrs(state, bits), rng.data_ptr(), next_rng.data_ptr(), rows.data_ptr(), b,
            bits[0].shape[-1], state.chain_time.shape[-1], float(dyn.step_time),
            int(num_steps), torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error(err, "decay frame")
    count("kernels.decay_stats_frame.launches")
    return next_rng


def _check_carry(state: NucleusState, bits: tuple, what: str) -> None:
    """Raise unless the carry is what the kernel takes: on one CUDA device,
    the listed dtypes and shapes, contiguous, W and C at least 1."""
    dev = state.z.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, not {dev}")
    b = state.z.shape[0]
    w = bits[0].shape[-1]
    c = state.chain_time.shape[-1]
    if w < 1 or c < 1:
        raise ValueError(f"needs at least one bitfield word and chain slot, got W={w}, C={c}")
    i32, f32, i64 = (torch.int32,), (torch.float32,), (torch.int64,)
    for name in ("z", "n", "chain_cursor"):
        _build.check_tensor(getattr(state, name), name, i32, (b,), dev)
    for name in ("half_life", "time_passed", "last_decay_time"):
        _build.check_tensor(getattr(state, name), name, f32, (b,), dev)
    _build.check_tensor(state.decay_counts, "decay_counts", i32, (b, NUM_DECAY_TYPES), dev)
    _build.check_tensor(bits[0], "alive_bits", i64, (b, w), dev)
    _build.check_tensor(bits[1], "proton_bits", i64, (b, w), dev)
    for name in ("chain_z0", "chain_n0", "chain_dtype", "chain_z1", "chain_n1"):
        _build.check_tensor(getattr(state, name), name, i32, (b, c), dev)
    _build.check_tensor(state.chain_time, "chain_time", f32, (b, c), dev)


def _carry_ptrs(state: NucleusState, bits: tuple) -> list:
    """The carry's pointers in the order of the kernel's entry point."""
    return [
        state.z.data_ptr(), state.n.data_ptr(), state.chain_cursor.data_ptr(),
        state.half_life.data_ptr(), state.time_passed.data_ptr(),
        state.last_decay_time.data_ptr(), state.decay_counts.data_ptr(),
        bits[0].data_ptr(), bits[1].data_ptr(), state.chain_z0.data_ptr(),
        state.chain_n0.data_ptr(), state.chain_dtype.data_ptr(), state.chain_z1.data_ptr(),
        state.chain_n1.data_ptr(), state.chain_time.data_ptr(),
    ]
