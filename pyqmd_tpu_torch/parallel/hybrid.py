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
package's form is ``pyqmd_tpu/parallel/hybrid.py``, one compiled program.

On the card the frame replays a CUDA graph per bucket with the ring's
collectives over ``model`` inside it, as :func:`make_ring_frame_fn` does;
the aggregates' ``all_reduce`` over ``data`` runs after each replay,
outside the graph (:func:`~pyqmd_tpu_torch.parallel.ensemble.sharded_frame`).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core.step import frame_graphs
from pyqmd_tpu_torch.parallel.ensemble import sharded_frame
from pyqmd_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from pyqmd_tpu_torch.parallel.ring import _check_divisible, group_label, make_ring_force_step

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
    before the replicated decay and overlap passes. The result is bitwise
    :func:`~pyqmd_tpu_torch.parallel.ensemble.sharded_frame` around
    ``ensemble_step`` with :func:`make_ring_force_step` as its force step.

    Every rank must make the same calls in lockstep: the local batch is
    equal on every rank (:func:`shard_ensemble` requires the division), so
    all ranks of a ``model`` group capture at the same call. ``fn.graphs``
    is the frame's :class:`~pyqmd_tpu_torch.core.graphs.FrameGraphs`,
    owned by this call.
    """
    _check_divisible(cfg.max_particles, mesh, model_axis)
    ring = make_ring_force_step(cfg, mesh, model_axis)
    graphs = frame_graphs(cfg, num_steps, True, ring, group_label(mesh, model_axis))
    call = sharded_frame(lambda st, ts, fdt: graphs(st, ts, fdt, None, None),
                         cfg, mesh, data_axis)
    call.graphs = graphs
    return call
