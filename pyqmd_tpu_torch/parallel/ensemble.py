"""Sharded ensemble frames: the batch over the ``data`` group, aggregate
statistics summed across it.

The ensemble is a batch of independent nuclei, so each rank runs the
port's own batched frame (``make_frame_fn``, ``make_run_fn``,
``decay_ensemble_step`` of :mod:`pyqmd_tpu_torch.core.step`) on its rows,
through the same kernels as one card, and the only traffic is one
``all_reduce`` of a packed int32 vector per frame: the decay counts, the
alive total and the survivors. The per-nucleus metrics stay with the
rank's rows. The JAX package's form is ``shard_map`` with ``psum`` over
the mesh axis, compiled as one program (``pyqmd_tpu/parallel/ensemble.py``).

On the card the full-physics frames replay the single-card CUDA graph of
the rank's bucket (:mod:`pyqmd_tpu_torch.core.graphs`: the local batch,
the device, the regime), and the ``all_reduce`` runs once after each
replay, outside the graph; on CPU tensors they run eagerly. The decay-only
frame stays eager: it is one kernel launch per frame.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core.step import decay_ensemble_step, make_frame_fn, make_run_fn
from pyqmd_tpu_torch.parallel.mesh import DATA_AXIS
from pyqmd_tpu_torch.utils.profiling import annotate

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh


def psum_aggregates(metrics: dict, cfg: SimConfig, group) -> dict:
    """Attach the cross-shard aggregates to per-shard metrics: decay counts
    and alive totals summed over ``group``, plus ``survivors`` (nuclei
    still in their initial isotope — the half-life statistics numerator).
    All three are int32, reduced as one vector, eagerly, in the span
    ``pyqmd.ensemble.all_reduce``."""
    with annotate("pyqmd.ensemble.all_reduce"):
        if "total_decay_counts" not in metrics:  # raw state_metrics output
            metrics["total_decay_counts"] = metrics["decay_counts"].sum(0, dtype=torch.int32)
            metrics["total_alive"] = metrics["alive"].sum(dtype=torch.int32)
        survivors = ((metrics["z"] == cfg.z) & (metrics["n"] == cfg.n)).sum(dtype=torch.int32)
        packed = torch.cat([
            metrics["total_decay_counts"].to(torch.int32),
            metrics["total_alive"].to(torch.int32).reshape(1),
            survivors.reshape(1),
        ])
        dist.all_reduce(packed, group=group)
        k = metrics["total_decay_counts"].numel()
        metrics["total_decay_counts"] = packed[:k]
        metrics["total_alive"] = packed[k]
        metrics["survivors"] = packed[k + 1]
        return metrics


def sharded_frame(local_fn, cfg: SimConfig, mesh: DeviceMesh, axis: str):
    """Wrap a ``local_fn(states, time_scale, frame_dt) -> (states,
    metrics)`` on this rank's rows so that its aggregates are summed over
    the ``axis`` group of ``mesh``: the one place the per-frame reduction
    lives, shared with :mod:`pyqmd_tpu_torch.parallel.hybrid`."""
    group = mesh.get_group(axis)

    def call(states, time_scale, frame_dt):
        states, metrics = local_fn(states, time_scale, frame_dt)
        return states, psum_aggregates(metrics, cfg, group)

    return call


def make_sharded_frame_fn(cfg: SimConfig, num_steps: int, mesh: DeviceMesh,
                          axis: str = DATA_AXIS):
    """Sharded ensemble frame.

    Returns ``fn(states, time_scale, frame_dt) -> (states, metrics)`` where
    ``states`` are this rank's rows (:func:`shard_ensemble`). Per-nucleus
    metrics stay with the rows; ``total_decay_counts``, ``total_alive`` and
    ``survivors`` are summed over the ``axis`` group. The local frame is
    :func:`pyqmd_tpu_torch.core.step.make_frame_fn`'s, with no raw physics
    dt as in the JAX package's sharded frames: bitwise
    :func:`~pyqmd_tpu_torch.core.step.ensemble_step`, a graph replay per
    call on the card; ``fn.graphs`` is its
    :class:`~pyqmd_tpu_torch.core.graphs.FrameGraphs`.
    """
    frame = make_frame_fn(cfg, num_steps, batched=True)
    call = sharded_frame(
        lambda st, ts, fdt: frame(st, ts, fdt, cfg.effective_dt(), None), cfg, mesh, axis
    )
    call.graphs = frame.graphs
    return call


def make_sharded_decay_fn(cfg: SimConfig, num_steps: int, mesh: DeviceMesh,
                          axis: str = DATA_AXIS):
    """Sharded decay-only frame: :func:`decay_ensemble_step` (one decay
    frame-kernel launch per frame on the card) on this rank's rows, with
    the aggregates summed over ``axis``. Isotope trajectories are bitwise
    those of the sharded full-physics frame."""
    return sharded_frame(
        lambda st, ts, fdt: decay_ensemble_step(st, cfg, ts, fdt, num_steps), cfg, mesh, axis
    )


def make_sharded_run_fn(cfg: SimConfig, num_steps: int, num_frames: int, mesh: DeviceMesh,
                        axis: str = DATA_AXIS):
    """Fused sharded run: ``num_frames`` whole frames of
    :func:`pyqmd_tpu_torch.core.step.make_run_fn` on this rank's rows with
    no collective between them, at a constant time scale (on the card the
    frame's graph replayed ``num_frames`` times). Returns the final state
    and its metrics, the aggregates summed over ``axis`` by one
    ``all_reduce`` after the last frame."""
    run = make_run_fn(cfg, num_steps, num_frames, batched=True)
    # The JAX package's sharded frames pass no raw physics dt.
    return sharded_frame(
        lambda st, ts, fdt: run(st, ts, fdt, raw_physics_dt=None), cfg, mesh, axis
    )


def survival_fraction(metrics, cfg: SimConfig, batch: int):
    """Fraction of the ensemble still in the initial isotope."""
    return metrics["survivors"] / batch
