"""Wrapper of the CUDA decay-statistics kernel (``csrc/decay.cu``).

:func:`decay_stats_substep` runs one statistics-only decay substep for every
nucleus and updates the frame's carry in place. CPU tensors take the plain
version, :func:`pyqmd_tpu_torch.core.decay.maybe_decay` with
``stats_only=True`` and ``packed_nucleons``, whose result is copied into the
carry; CUDA tensors launch the kernel, or the call raises. The kernel
replaces ``pyqmd_tpu/kernels/decay_pallas.py`` ``_decay_stats_kernel``.
"""

from __future__ import annotations

import torch

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import decay as _plain
from pyqmd_tpu_torch.core.dynamics import FrameDynamics
from pyqmd_tpu_torch.data import tables
from pyqmd_tpu_torch.kernels import _build
from pyqmd_tpu_torch.state import NUM_DECAY_TYPES, NucleusState

# The state fields a substep writes (it also reads time_passed).
DECAY_FIELDS = (
    "z", "n", "chain_cursor", "half_life", "last_decay_time", "decay_counts",
    "chain_z0", "chain_n0", "chain_dtype", "chain_z1", "chain_n1", "chain_time",
)


def decay_stats_substep(
    state: NucleusState, bits: tuple, cfg: SimConfig, keys: torch.Tensor, dyn: FrameDynamics
) -> None:
    """One statistics-only decay substep, in place.

    ``state``'s :data:`DECAY_FIELDS` and ``bits = (alive_bits,
    proton_bits)``, (B, W) int64 words of :func:`pack_nucleon_bits
    <pyqmd_tpu_torch.core.decay.pack_nucleon_bits>`, are updated; ``keys``
    (B, 2) int64 are the nuclei's substep keys and ``dyn.step_time`` the
    Bernoulli interval. Positions, velocities, ejecta and ``state.alive`` /
    ``state.ptype`` are neither read nor written.
    """
    dev = state.z.device
    if dev.type == "cpu":
        new, _, new_bits = _plain.maybe_decay(
            state, cfg, keys, dyn, stats_only=True, packed_nucleons=bits
        )
        for f in DECAY_FIELDS:
            getattr(state, f).copy_(getattr(new, f))
        for old, nb in zip(bits, new_bits):
            old.copy_(nb)
        return
    if dev.type != "cuda":
        raise ValueError(f"decay_stats_substep runs on CPU or CUDA tensors, not {dev}")
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
    _build.check_tensor(keys, "keys", i64, (b, 2), dev)
    rows = tables.rows_on(dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.pyqmd_decay_stats(
            state.z.data_ptr(), state.n.data_ptr(), state.chain_cursor.data_ptr(),
            state.half_life.data_ptr(), state.time_passed.data_ptr(),
            state.last_decay_time.data_ptr(), state.decay_counts.data_ptr(),
            bits[0].data_ptr(), bits[1].data_ptr(), state.chain_z0.data_ptr(),
            state.chain_n0.data_ptr(), state.chain_dtype.data_ptr(),
            state.chain_z1.data_ptr(), state.chain_n1.data_ptr(),
            state.chain_time.data_ptr(), keys.data_ptr(), rows.data_ptr(), b, w, c,
            float(dyn.step_time), torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error(err, "decay")
    decay_stats_substep.launches += 1


decay_stats_substep.launches = 0
