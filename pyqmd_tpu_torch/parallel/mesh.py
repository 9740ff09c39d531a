"""Process groups as a device mesh: one process per device.

The JAX package drives every device from one controller and names its
axes on a ``jax.sharding.Mesh``. PyTorch's idiom is one rank per card, so
a mesh here is a :class:`torch.distributed.device_mesh.DeviceMesh` over
the world's ranks, and each named dimension carries the process group
that the sharded frames reduce over: ``data`` for the ensemble batch,
``model`` for the particle axis of the ring.

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``. A
collective needs a group where ``psum`` needs none, so :func:`make_mesh`
in a process that has no group starts a world of one itself.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

from pyqmd_tpu_torch.state import NucleusState

if TYPE_CHECKING:  # the mesh and placement modules load on first use
    from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"  # ensemble (batch) axis — the primary scale dimension
MODEL_AXIS = "model"  # particle axis — the ring-sharded N^2 dimension


def backend_for(device) -> str:
    """The collective backend of a device type: NCCL on the card, gloo on
    the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device!r}")


def rank_device(device) -> torch.device:
    """This rank's device: its current card for ``cuda`` (raising without
    one), else the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, and no CUDA device is present")
    return torch.device("cuda", torch.cuda.current_device() if device.index is None
                        else device.index)


def _start_world_of_one(device) -> None:
    """rank 0 of 1, through a file store in a directory of its own."""
    backend = backend_for(device)
    kw = {}
    if backend == "nccl":
        dev = rank_device(device)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    store = os.path.join(tempfile.mkdtemp(prefix="pyqmd_world_"), "rendezvous")
    dist.init_process_group(backend, init_method=f"file://{store}", rank=0, world_size=1, **kw)


def make_mesh(
    shape: tuple[int, ...] | None = None,
    axis_names: tuple[str, ...] = (DATA_AXIS,),
    device="cuda",
) -> DeviceMesh:
    """A mesh over every rank of the world, one per device.

    Default: a 1-D ``data`` mesh. Pass ``shape=(d, m), axis_names=('data',
    'model')`` for the 2-D ensemble x particle layout, ranks laid out
    row-major (a rank's ``model`` neighbours are consecutive). ``device``
    names the device type, the card unless the caller asks for the CPU.
    Without a process group this starts a world of one.
    """
    device = torch.device(device)
    if device.type == "cuda":
        rank_device(device)  # raises without a card
    if not dist.is_initialized():
        _start_world_of_one(device)
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    shape = tuple(shape)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(
            f"mesh shape {shape} covers {n} of {world} ranks; a mesh spans the world"
        )
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, shape, mesh_dim_names=tuple(axis_names))


def _placements(mesh: DeviceMesh, axis: str | None) -> list:
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def batch_sharding(mesh: DeviceMesh, axis: str = DATA_AXIS) -> list:
    """Placements that split the leading (ensemble) axis across ``axis``
    and replicate it over the other mesh dimensions."""
    return _placements(mesh, axis)


def replicated(mesh: DeviceMesh) -> list:
    return _placements(mesh, None)


def local_rows(mesh: DeviceMesh, batch: int, axis: str = DATA_AXIS) -> slice:
    """The rows of a ``batch``-member ensemble that this rank holds."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if batch % n:
        raise ValueError(f"batch {batch} not divisible by mesh axis {axis!r} size {n}")
    size = batch // n
    start = mesh.get_local_rank(axis) * size
    return slice(start, start + size)


def shard_ensemble(states: NucleusState, mesh: DeviceMesh, axis: str = DATA_AXIS) -> NucleusState:
    """This rank's rows of a batched state, on the rank's device.

    Every rank passes the same global batch, as ``jax.device_put`` of a
    global array takes one, and keeps rows ``[i * B/n, (i + 1) * B/n)``
    for its index ``i`` along ``axis``; ranks that differ only along
    another axis hold the same rows."""
    rows = local_rows(mesh, states.batch, axis)
    dev = rank_device(mesh.device_type)
    return NucleusState(**{
        f.name: getattr(states, f.name)[rows].to(dev, copy=True).contiguous()
        for f in dataclasses.fields(states)
    })
