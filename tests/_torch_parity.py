"""Shared helpers of the ``test_torch_*`` parity tests: the JAX package and
the PyTorch port run on the same inputs and are compared here.

Importing this module caps torch's intra-op threads: the tier-1 suite runs
several pytest workers side by side.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pyqmd_tpu_torch.config import config_from_dict
from pyqmd_tpu_torch.state import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

# Integer and RNG fields of a state: these must match bitwise.
INT_FIELDS = (
    "ptype", "alive", "z", "n", "ej_type", "ej_alive", "ej_cursor", "rng",
    "decay_counts", "chain_z0", "chain_n0", "chain_dtype", "chain_z1",
    "chain_n1", "chain_cursor",
)


def jax_to_numpy(st) -> dict:
    """``{field: ndarray}`` of a JAX ``NucleusState``."""
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def to_port(st):
    """A JAX state as a port state on the CPU."""
    return state_from_numpy(jax_to_numpy(st), device="cpu")


def port_cfg(jax_cfg):
    """The port's config equal to a JAX config."""
    return config_from_dict(dataclasses.asdict(jax_cfg))


def assert_fields_equal(ref: dict, got, fields):
    """Bitwise equality of ``fields`` between numpy dict ``ref`` and port
    state ``got``."""
    got = state_to_numpy(got)
    for f in fields:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def assert_rel_close(a, b, rtol, name=""):
    """Relative closeness where inf == inf counts as equal."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, name
    both_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    with np.errstate(invalid="ignore"):
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-30)
    rel[both_inf] = 0.0
    assert float(rel.max(initial=0.0)) <= rtol, (name, float(rel.max()))


def batch_of_one(arrays: dict) -> dict:
    """A lone JAX nucleus's ``{field: ndarray}`` with the batch axis the
    port carries."""
    return {k: np.asarray(v)[None] for k, v in arrays.items()}


def to_port_single(st):
    """A lone (unbatched) JAX state as the port's batch of one on the CPU."""
    return state_from_numpy(batch_of_one(jax_to_numpy(st)), device="cpu")


class OpLog(TorchDispatchMode):
    """Every op dispatched, the process groups' collectives among them,
    with its arguments: tensors as (shape, dtype, stride), TorchScript
    objects (a process group, a reduce op) by their type, everything else
    as it is; and the storages of the tensors read. A CUDA graph replays
    the ops its capture saw with the arguments they had then, so two calls
    of one bucket must log alike."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.storages = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}

        def sig(a):
            if isinstance(a, torch.Tensor):
                self.storages.add(a.untyped_storage().data_ptr())
                return ("tensor", tuple(a.shape), a.dtype, a.stride())
            if isinstance(a, torch.ScriptObject):
                return ("script", a._type().qualified_name())
            if isinstance(a, (list, tuple)):
                return tuple(sig(x) for x in a)
            return a

        self.ops.append((str(func), sig(args), tuple(sorted((k, sig(v))
                                                           for k, v in kwargs.items()))))
        return func(*args, **kwargs)
