"""Checkpoint / resume: the simulation state as an ``.npz`` archive.

The format is the JAX package's, version 1, so either package reads the
other's files: one array per state field with the JAX dtypes (``rng`` as
uint32; a lone nucleus stored without its batch axis) plus ``__meta__``,
the JSON of ``{"version": 1, "config": {...}}``. The config dict carries
the JAX package's two backend selectors at values it accepts; the port has
neither field and drops them on load.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from pyqmd_tpu_torch.config import SimConfig, config_from_dict
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
    meta = json.dumps(
        {
            "version": _FORMAT_VERSION,
            "config": {**dataclasses.asdict(cfg), **_JAX_BACKENDS},
        }
    )
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


def load_checkpoint(path: str, device="cuda") -> tuple[NucleusState, SimConfig]:
    """Load ``(state, config)`` from an ``.npz`` checkpoint onto ``device``
    (the card unless the caller names another). A lone nucleus comes back
    as a batch of one."""
    state, cfg, _ = read_checkpoint(path, device)
    return state, cfg
