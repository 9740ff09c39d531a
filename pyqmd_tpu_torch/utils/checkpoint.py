"""Checkpoint / resume: the simulation state as an ``.npz`` archive.

The format is the JAX package's, version 1, so either package reads the
other's files: one array per state field with the JAX dtypes (``rng`` as
uint32; a lone nucleus stored without its batch axis) plus ``__meta__``,
the JSON of ``{"version": 1, "config": {...}}``. The config dict carries
the JAX package's two backend selectors at values it accepts; the port has
neither field and drops them on load.

:func:`save_checkpoint_sharded` / :func:`load_checkpoint_sharded` stand
where the JAX package's Orbax pair stands (``save_checkpoint_orbax`` /
``load_checkpoint_orbax``): a directory with the state written by
``torch.distributed.checkpoint``, each rank its own rows, and the same
``config.json``. Orbax imports JAX, so the port neither reads nor writes
Orbax directories.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from pyqmd_tpu_torch.config import SimConfig, config_from_dict
from pyqmd_tpu_torch.parallel.mesh import DATA_AXIS, batch_sharding, rank_device
from pyqmd_tpu_torch.state import NucleusState, state_from_numpy, state_to_numpy

_FORMAT_VERSION = 1

# The JAX config's backend selectors, written so that its SimConfig(**config)
# accepts a file of the port: the portable force path and its default decay
# path.
_JAX_BACKENDS = {"force_backend": "jnp", "decay_backend": "auto"}


def save_checkpoint(
    path: str, state: NucleusState, cfg: SimConfig, *, single: bool = False
) -> None:
    """Write state + config to ``path`` (.npz). ``single`` stores a batch
    of one as the JAX package stores a lone nucleus, without the batch
    axis."""
    arrays = state_to_numpy(state)
    if single:
        if state.batch != 1:
            raise ValueError(f"single=True takes a batch of 1, got {state.batch}")
        arrays = {k: a[0] for k, a in arrays.items()}
    meta = json.dumps(_meta(cfg))
    np.savez_compressed(path, __meta__=np.frombuffer(meta.encode(), np.uint8), **arrays)


def read_checkpoint(path: str, device="cuda") -> tuple[NucleusState, SimConfig, bool]:
    """:func:`load_checkpoint` plus ``single``: whether the file held a lone
    nucleus, whose state comes back as a batch of one."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta.get("version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta.get('version')}")
        cfg = config_from_dict(meta["config"])
        fields = {f.name for f in dataclasses.fields(NucleusState)}
        arrays = {k: np.asarray(v) for k, v in data.items() if k in fields}
    missing = fields - set(arrays)
    if missing:
        raise ValueError(f"checkpoint missing fields: {sorted(missing)}")
    single = arrays["pos"].ndim == 2
    if single:
        arrays = {k: a[None] for k, a in arrays.items()}
    return state_from_numpy(arrays, device=device), cfg, single


def _meta(cfg: SimConfig) -> dict:
    return {"version": _FORMAT_VERSION, "config": {**dataclasses.asdict(cfg), **_JAX_BACKENDS}}


def load_checkpoint(path: str, device="cuda") -> tuple[NucleusState, SimConfig]:
    """Load ``(state, config)`` from an ``.npz`` checkpoint onto ``device``
    (the card unless the caller names another). A lone nucleus comes back
    as a batch of one."""
    state, cfg, _ = read_checkpoint(path, device)
    return state, cfg


def _as_shards(tensors: dict, mesh, axis: str) -> dict:
    """Each tensor, this rank's rows, as a DTensor split over ``axis`` and
    replicated over the mesh's other dimensions."""
    from torch.distributed.tensor import DTensor

    placements = batch_sharding(mesh, axis)
    return {k: DTensor.from_local(t, mesh, placements, run_check=False) for k, t in tensors.items()}


def save_checkpoint_sharded(
    path: str, state: NucleusState, cfg: SimConfig, mesh=None, axis: str = DATA_AXIS
) -> None:
    """Write a state split over ranks to the directory ``path`` without
    gathering it: ``state`` holds this rank's rows along ``axis`` of
    ``mesh`` (:func:`pyqmd_tpu_torch.parallel.shard_ensemble`), every rank
    of the world calls this, and each row is written once, by one of the
    ranks that hold it. Without a mesh the state is written whole, from one
    process or from every rank alike."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    tensors = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    if mesh is not None:
        tensors = _as_shards(tensors, mesh, axis)
    if not dist.is_initialized() or dist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(_meta(cfg), f)
    # Without a group, torch.distributed.checkpoint writes from this process alone.
    dcp.save(tensors, checkpoint_id=os.path.join(path, "state"))


def load_checkpoint_sharded(
    path: str,
    sharding_state: NucleusState | None = None,
    mesh=None,
    axis: str = DATA_AXIS,
    *,
    device="cuda",
) -> tuple[NucleusState, SimConfig]:
    """Restore a directory of :func:`save_checkpoint_sharded`.

    ``sharding_state`` (optional) is a template — typically the state about
    to be replaced — whose shapes, dtypes and devices the restore
    reproduces: with ``mesh`` it holds this rank's rows along ``axis`` and
    only those rows are read; without, it is the whole state. With no
    template the whole state comes back on ``device`` (the card unless the
    caller names another), ``mesh`` unused, in one process with no group
    as on every rank of one."""
    import torch
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    if meta.get("version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta.get('version')}")
    cfg = config_from_dict(meta["config"])
    state_dir = os.path.join(path, "state")
    names = [f.name for f in dataclasses.fields(NucleusState)]
    if sharding_state is not None:
        target = {k: torch.empty_like(getattr(sharding_state, k)) for k in names}
    else:
        saved = dcp.FileSystemReader(state_dir).read_metadata().state_dict_metadata
        missing = set(names) - set(saved)
        if missing:
            raise ValueError(f"checkpoint missing fields: {sorted(missing)}")
        dev = rank_device(device)
        target = {k: torch.empty(tuple(saved[k].size), dtype=saved[k].properties.dtype,
                                 device=dev) for k in names}
    sharded = sharding_state is not None and mesh is not None
    if sharded:
        target = _as_shards(target, mesh, axis)
    dcp.load(target, checkpoint_id=state_dir)
    if sharded:
        target = {k: t.to_local() for k, t in target.items()}
    return NucleusState(**target), cfg
