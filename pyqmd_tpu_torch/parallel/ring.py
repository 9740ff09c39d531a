"""Particle-axis sharded force: the ring over the ``model`` group.

The n-body counterpart of ring attention. The particle axis is split over
the ranks of a ``model`` group: each rank keeps its i-block fixed and
adds the pair forces of a j-block that travels round the ring by
``batch_isend_irecv``, so that after D hops every i-block has seen every
j-block. The alive count and the centre of mass are ``all_reduce``d
first, so the physics is :func:`pyqmd_tpu_torch.core.forces.force_step`
up to the f32 order of the sums. The JAX package's form passes the blocks
by ``ppermute`` inside ``shard_map`` (``pyqmd_tpu/parallel/ring.py``).

Each hop is :func:`pyqmd_tpu_torch.core.forces.pair_forces_block` in
tensor code, on CUDA tensors on the card, as in the reference, where the
hop is jnp outside any Pallas kernel.

The ring step reads no tensor on the host and takes ``dt`` as a 0-d
tensor, so :func:`make_ring_frame_fn` replays it inside the frame's CUDA
graph on the card, its ``all_reduce``s, exchanges and ``all_gather``
captured with the rest (NCCL); the JAX package's ring runs inside one
jitted program (``pyqmd_tpu/parallel/ring.py:118``). Called alone,
:func:`make_ring_force_step` runs eagerly.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core.forces import com_force, pair_forces_block
from pyqmd_tpu_torch.core.step import frame_graphs
from pyqmd_tpu_torch.parallel.mesh import MODEL_AXIS

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh


def _pack_block(pos, ptype, alive):
    """(..., n, 2) f32, (..., n) int32, (..., n) bool as one (..., n, 4)
    int32 message: one send per hop."""
    return torch.cat([pos.view(torch.int32), ptype[..., None].to(torch.int32),
                      alive[..., None].to(torch.int32)], dim=-1).contiguous()


def _unpack_block(block):
    return block[..., :2].contiguous().view(torch.float32), block[..., 2], block[..., 3] != 0


def _ring_force_local(pos, vel, ptype, alive, dt, cfg: SimConfig, group):
    """One force + integrate step of this rank's particle block: pos/vel
    (..., P/D, 2), ptype/alive (..., P/D), any leading dims."""
    d = dist.get_world_size(group)
    me = dist.get_rank(group)
    right = dist.get_global_rank(group, (me + 1) % d)
    left = dist.get_global_rank(group, (me - 1) % d)
    m = alive.to(torch.float32)

    # The alive count over the whole particle set; independent of position.
    count = m.sum(-1)
    dist.all_reduce(count, group=group)
    safe = torch.clamp(count, min=1.0)

    def total_force(p):
        """The pair sweep round the ring plus the CoM spring at positions
        ``p``; leapfrog evaluates it at two positions, the centre reduced
        at each."""
        center = (p * m[..., None]).sum(-2)
        dist.all_reduce(center, group=group)
        center = center / safe[..., None]

        block = _pack_block(p, ptype, alive)
        acc = torch.zeros_like(p)
        # D hops, D - 1 exchanges: the last block is not sent on (a ring of
        # one sends nothing). The next block travels while this one is
        # summed, into a buffer of its own.
        for hop in range(d):
            reqs = []
            if hop < d - 1:
                incoming = torch.empty_like(block)
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, block, right, group),
                    dist.P2POp(dist.irecv, incoming, left, group),
                ])
            acc = acc + pair_forces_block(p, ptype, alive, *_unpack_block(block), cfg)
            for req in reqs:
                req.wait()
            if reqs:
                block = incoming
        return acc + com_force(p, center, safe, cfg) * m[..., None]

    if not isinstance(dt, torch.Tensor):
        dt = float(dt)
    keep = alive[..., None]
    if cfg.integrator == "leapfrog":
        f1 = total_force(pos)
        v_half = vel + f1 * (0.5 * dt)
        new_pos = pos + v_half * dt
        f2 = total_force(new_pos)
        new_vel = (v_half + f2 * (0.5 * dt)) * cfg.damping
    else:
        force = total_force(pos)
        new_vel = (vel + force * dt) * cfg.damping
        new_pos = pos + new_vel * dt
    return torch.where(keep, new_pos, pos), torch.where(keep, new_vel, vel)


def _check_divisible(p: int, mesh: DeviceMesh, axis: str) -> int:
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if p % n:
        raise ValueError(f"max_particles={p} not divisible by mesh axis {axis!r} size {n}")
    return n


def group_label(mesh: DeviceMesh, axis: str) -> str:
    """The ``axis`` group of ``mesh`` as a graph bucket's name gives it:
    its global ranks and its backend."""
    group = mesh.get_group(axis)
    return (f"{axis} group of ranks {dist.get_process_group_ranks(group)} "
            f"({dist.get_backend(group)})")


def make_ring_force_step(cfg: SimConfig, mesh: DeviceMesh, axis: str = MODEL_AXIS):
    """A force step with the particle axis sharded over ``axis``: the
    semantics of :func:`pyqmd_tpu_torch.kernels.forces.force_step`,
    ``step(pos, vel, ptype, alive, dt[, cfg])``, for any leading dims and P
    divisible by the axis size, so that it also serves as a frame's
    ``force_step_fn``.

    Every rank of the ``axis`` group passes the same full-width tensors and
    steps its own particle block through the ring; the blocks are gathered
    back along the particle axis, so every rank returns the full result.
    The step runs eagerly; the frames of :func:`make_ring_frame_fn` and
    :func:`~pyqmd_tpu_torch.parallel.hybrid.make_hybrid_frame_fn` capture
    it as part of theirs.
    """
    group = mesh.get_group(axis)

    def step(pos, vel, ptype, alive, dt, _cfg=None):
        n = _check_divisible(ptype.shape[-1], mesh, axis)
        size = ptype.shape[-1] // n
        start = dist.get_rank(group) * size
        rows = slice(start, start + size)
        new_pos, new_vel = _ring_force_local(
            pos[..., rows, :], vel[..., rows, :], ptype[..., rows], alive[..., rows],
            dt, cfg, group,
        )
        mine = torch.cat([new_pos, new_vel], dim=-1).contiguous()  # one gather
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine, group=group)
        full = torch.cat(parts, dim=-2)
        return full[..., :2].contiguous(), full[..., 2:].contiguous()

    return step


def make_ring_frame_fn(cfg: SimConfig, num_steps: int, mesh: DeviceMesh,
                       axis: str = MODEL_AXIS):
    """A FULL single-nucleus frame with the force step sharded over
    ``axis``.

    The whole of :func:`pyqmd_tpu_torch.core.step.simulate_frame` (ejecta,
    decay sampling, chain log, overlap) runs replicated on every rank of
    the group, and every substep's O(N^2) force + integrate runs as the
    ring over the particle axis. ``cfg.max_particles`` must be divisible by
    the ``axis`` size. The result is bitwise ``simulate_frame`` with
    :func:`make_ring_force_step` as its ``force_step_fn``.

    On the card each graph bucket (:mod:`pyqmd_tpu_torch.core.graphs`) is
    captured at its first call, the ring's collectives inside the graph,
    and replayed after. Every rank of the group must make the same calls
    in lockstep: the batch is 1 everywhere, so all ranks capture at the
    same call, and a rank that captured alone would wait in its
    collectives for the others. On CPU tensors the frame runs eagerly.
    ``frame.graphs`` is the frame's
    :class:`~pyqmd_tpu_torch.core.graphs.FrameGraphs`, which this call
    owns: a bucket never outlives the frame function or crosses meshes.
    """
    _check_divisible(cfg.max_particles, mesh, axis)
    graphs = frame_graphs(cfg, num_steps, False, make_ring_force_step(cfg, mesh, axis),
                          group_label(mesh, axis))

    def frame(state, time_scale, frame_dt):
        if state.batch != 1:
            raise ValueError(f"simulate_frame takes a batch of 1, got {state.batch}")
        return graphs(state, time_scale, frame_dt, None, None)

    frame.graphs = graphs
    return frame
