"""Multi-process start: one rank per card, across hosts.

The JAX package's multi-host start is ``jax.distributed.initialize``,
after which one controller sees every device. Here every card has a
process of its own, and the step before any mesh is
``torch.distributed.init_process_group``: a launcher (``torchrun``, SLURM,
Open MPI) starts the processes and says in the environment how many there
are and which one this is. A plain single-process start is a no-op, so one
launcher script runs everywhere; :func:`pyqmd_tpu_torch.parallel.make_mesh`
then starts a world of one itself.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from pyqmd_tpu_torch.parallel.mesh import backend_for, rank_device

logger = logging.getLogger("pyqmd_tpu_torch")

# (world size, rank, rank on this host) as each launcher exports them:
# torchrun, SLURM, Open MPI.
_LAUNCHER_ENV_VARS = (
    ("WORLD_SIZE", "RANK", "LOCAL_RANK"),
    ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"),
    ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"),
)


def _env_int(name: str) -> int | None:
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return None


def _launcher_world() -> tuple[int, int | None, int | None] | None:
    """(world size, rank, local rank) of the first launcher whose world
    size is set, else None."""
    for size_var, rank_var, local_var in _LAUNCHER_ENV_VARS:
        size = _env_int(size_var)
        if size is not None:
            return size, _env_int(rank_var), _env_int(local_var)
    return None


def cluster_detected() -> bool:
    """True when the environment shows a multi-*process* launch.

    Presence alone is not enough: ``torchrun --nproc-per-node 1`` exports
    ``WORLD_SIZE=1`` and a one-task SLURM job ``SLURM_NTASKS=1``; only a
    world of more than one counts. Detection reads environment variables
    only and touches no device. A job that its launcher does not describe
    passes the coordinator and the counts to :func:`initialize_multihost`.
    """
    world = _launcher_world()
    return world is not None and world[0] > 1


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> bool:
    """Start the process group; returns True if there is more than one
    process.

    With explicit arguments, always starts it (unless ``num_processes`` is
    1). With none, the launcher's environment decides (see
    :func:`cluster_detected`); a plain single-process start is a no-op.
    Missing values come from the environment: the counts from the
    launcher's variables, the coordinator from ``MASTER_ADDR`` and
    ``MASTER_PORT``. The group meets at ``tcp://<coordinator_address>``
    with the backend of ``device`` (NCCL on the card, after selecting the
    card of this rank's place on its host; gloo on the CPU).
    """
    explicit = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
    )
    if num_processes == 1 or (not explicit and not cluster_detected()):
        logger.info("single process; skipping init_process_group")
        return False
    env_size, env_rank, env_local = _launcher_world() or (None, None, None)
    num_processes = env_size if num_processes is None else num_processes
    process_id = env_rank if process_id is None else process_id
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', 29500)}"
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "initialize_multihost needs the coordinator address, the process count "
            f"and this process's id; have {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r}"
        )
    kw = {}
    backend = backend_for(device)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' asked for, and no CUDA device is present")
        local = env_local if env_local is not None else process_id % torch.cuda.device_count()
        torch.cuda.set_device(local)
        kw["device_id"] = rank_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kw,
    )
    logger.info("process group up: rank %d of %d (%s)", dist.get_rank(),
                dist.get_world_size(), backend)
    return True


def local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(start, size) of this rank's shard of a batch split over the whole
    world — for building per-rank inputs."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    size = global_batch // n
    return rank * size, size
