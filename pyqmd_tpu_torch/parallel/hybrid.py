"""Hybrid data x model sharded ensemble frame.

The two parallel axes composed: the ensemble batch is split over the
``data`` group (each replica owns B/data nuclei), and within each replica
every substep's O(N^2) force sweep splits the particle axis over the
``model`` group through the ring of :mod:`pyqmd_tpu_torch.parallel.ring`
— the n-body form of data parallelism combined with sequence parallelism.
Per-rank force work scales as B·P² / (data·model); the cheap per-nucleus
bookkeeping (decay sampling, ejecta, chain log, overlap) runs replicated
over ``model``, the same deterministic computation on every rank of a
replica, and the aggregate statistics are summed over ``data``. The JAX
package's form is ``pyqmd_tpu/parallel/hybrid.py``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core.step import ensemble_step
from pyqmd_tpu_torch.parallel.ensemble import sharded_frame
from pyqmd_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from pyqmd_tpu_torch.parallel.ring import _check_divisible, make_ring_force_step

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh


def make_hybrid_frame_fn(
    cfg: SimConfig,
    num_steps: int,
    mesh: DeviceMesh,
    data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS,
):
    """Ensemble frame sharded over BOTH mesh axes.

    Returns ``fn(states, time_scale, frame_dt) -> (states, metrics)``;
    ``states`` are this rank's rows along ``data_axis``
    (:func:`shard_ensemble`), and ``cfg.max_particles`` must divide by the
    ``model_axis`` size. The ring steps the rank's (B/data, P/model) slice
    batched; pos/vel are gathered over ``model`` along the particle axis
    before the replicated decay and overlap passes.
    """
    _check_divisible(cfg.max_particles, mesh, model_axis)
    ring = make_ring_force_step(cfg, mesh, model_axis)
    return sharded_frame(
        lambda st, ts, fdt: ensemble_step(st, cfg, ts, fdt, num_steps, force_step_fn=ring),
        cfg, mesh, data_axis,
    )
