"""Parallelism on ``torch.distributed``: one process per device, meshes
of process groups, sharded ensembles, the particle-axis ring.

The JAX package's ``pyqmd_tpu/parallel/`` drives every device from one
controller; here each card has a rank of its own, a mesh axis is a
``DeviceMesh`` dimension and its group, ``psum`` is ``all_reduce``,
``ppermute`` is ``batch_isend_irecv`` and ``all_gather`` stays
``all_gather``. The sharded checkpoint pair is
:func:`pyqmd_tpu_torch.utils.checkpoint.save_checkpoint_sharded` /
``load_checkpoint_sharded``.
"""

from pyqmd_tpu_torch.parallel.ensemble import (
    make_sharded_decay_fn,
    make_sharded_frame_fn,
    make_sharded_run_fn,
    survival_fraction,
)
from pyqmd_tpu_torch.parallel.hybrid import make_hybrid_frame_fn
from pyqmd_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    replicated,
    shard_ensemble,
)
from pyqmd_tpu_torch.parallel.multihost import initialize_multihost, local_batch_slice
from pyqmd_tpu_torch.parallel.ring import make_ring_force_step, make_ring_frame_fn

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "make_mesh",
    "initialize_multihost",
    "local_batch_slice",
    "make_hybrid_frame_fn",
    "make_ring_force_step",
    "make_ring_frame_fn",
    "make_sharded_decay_fn",
    "make_sharded_frame_fn",
    "make_sharded_run_fn",
    "replicated",
    "shard_ensemble",
    "survival_fraction",
]
