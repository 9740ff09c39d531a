"""Sharded C-14 survival statistics over a world of ranks, one per card.

Demonstrates the multi-card workflow end to end: a plain ``python`` start
spawns one rank per visible card (NCCL; one card runs a world of one in
this process); ``--cpu`` spawns 8 gloo ranks on the CPU, as the JAX
original's ``--cpu`` takes 8 virtual devices; under ``torchrun`` the
launcher's world is used as it is (``initialize_multihost`` reads it).

  * ``ensemble_init`` (pool placement) -> ``shard_ensemble`` over a 1-D
    ``data`` mesh: every rank builds the same global batch and keeps its
    rows,
  * ``make_sharded_run_fn``: 5 whole frames fused per call (4 calls), one
    decay frame-kernel launch per frame on the card, decay counters and
    survivor counts summed over the ranks,
  * half-life recovered from the summed survivor count, printed by rank 0.

Run: python examples_torch/sharded_survival.py [--cpu] [--per-device N]
     torchrun --nproc-per-node 4 examples_torch/sharded_survival.py
"""

import argparse
import math
import os
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from pyqmd_tpu_torch.config import SimConfig  # noqa: E402
from pyqmd_tpu_torch.core.init import ensemble_init  # noqa: E402
from pyqmd_tpu_torch.parallel import (  # noqa: E402
    initialize_multihost,
    make_mesh,
    make_sharded_run_fn,
    shard_ensemble,
)

HL = 5730 * 31557600.0  # C-14 (decay_chains.py:37)
CPU_RANKS = 8  # the JAX original's --cpu mesh: 8 virtual devices


def run(args, coordinator=None, num_processes=None, process_id=None):
    device = "cpu" if args.cpu else "cuda"
    if args.cpu:
        torch.set_num_threads(1)  # eight ranks share the host's cores
    initialize_multihost(coordinator, num_processes, process_id, device=device)
    mesh = make_mesh(device=device)  # 1-D 'data' axis over every rank
    n_dev = mesh.size()

    cfg = SimConfig.for_isotope(6, 8, pad_to=8)
    batch = args.per_device * n_dev
    states = shard_ensemble(ensemble_init(cfg, batch, seed=0, device=device), mesh)
    lead = dist.get_rank() == 0
    if lead:
        print(f"{batch} C-14 nuclei over {n_dev} devices ({dist.get_backend()})")

    # 2 tabulated half-lives of sim time: 4 sharded calls, each fusing
    # 5 frames x 10 substeps.
    frames_per_dispatch, dispatches, substeps = 5, 4, 10
    sim_seconds = 2.0 * HL
    frame_dt = 1.0
    time_scale = sim_seconds / (frames_per_dispatch * dispatches * frame_dt)
    fused = make_sharded_run_fn(cfg, substeps, frames_per_dispatch, mesh)
    for _ in range(dispatches):
        states, metrics = fused(states, time_scale, frame_dt)

    surv = int(metrics["survivors"]) / batch
    dist.destroy_process_group()
    if not lead:
        return
    if surv >= 1.0:
        # Possible at tiny --per-device counts (P(all survive 2 T1/2) =
        # 0.25^B): -log(1.0) = -0.0 would divide by zero.
        raise SystemExit(
            f"no decays in {batch} members over 2 half-lives — "
            "raise --per-device for a measurable fit"
        )
    fit_hl = math.log(2) * sim_seconds / -math.log(max(surv, 1e-9))
    err = abs(fit_hl - HL) / HL
    print(f"survival after 2 T1/2: {surv:.4f} (expect 0.25)")
    print(f"fitted half-life: {fit_hl / 31557600.0:.0f} yr "
          f"(tabulated 5730; rel. error {err:.2%})")
    # 5-sigma band, scaled to the ensemble size: sigma_rel of the T-fit at
    # S = 0.25 over 2 half-lives is sqrt(S(1-S)/B)/(S|ln S|) ~ 1.25/sqrt(B).
    tol = max(0.05, 6.25 / math.sqrt(batch))
    assert err < tol, f"statistical fit out of tolerance ({err:.2%} > {tol:.2%})"


def _spawned(rank, args, coordinator, world):
    run(args, coordinator, world, rank)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--cpu", action="store_true",
                        help=f"{CPU_RANKS} gloo ranks on the CPU (plain PyTorch)")
    parser.add_argument("--per-device", type=int, default=1024,
                        help="nuclei per rank (the smoke test uses a small value)")
    args = parser.parse_args()

    world = CPU_RANKS if args.cpu else torch.cuda.device_count()
    if "WORLD_SIZE" in os.environ or world == 1:
        run(args)  # torchrun's world, or one card: this process is the rank
        return
    if world == 0:
        raise SystemExit(f"no CUDA device; pass --cpu to run {CPU_RANKS} ranks on the CPU")
    with socket.socket() as s:  # a free port on this host for the coordinator
        s.bind(("localhost", 0))
        coordinator = f"localhost:{s.getsockname()[1]}"
    import torch.multiprocessing as mp

    mp.spawn(_spawned, args=(args, coordinator, world), nprocs=world, join=True)


if __name__ == "__main__":
    main()
