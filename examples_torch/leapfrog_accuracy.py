"""Integrator quality demo: velocity-Verlet vs the reference's Euler.

The reference integrates with damped semi-implicit Euler
(nuclear_forces.py:156-171), first-order accurate.
``SimConfig.integrator="leapfrog"`` (velocity-Verlet, second order) is
there on every path of this package: the plain PyTorch step and, fused as
two sweeps per step, both CUDA force kernels.

This script shows two textbook properties on an undamped three-nucleon
configuration:

1. **Convergence order**: halving dt cuts Euler's error ~2x but
   leapfrog's ~4x (global error O(dt) vs O(dt^2)).
2. **Time reversibility**: running N steps with +dt then N with -dt
   returns leapfrog to the initial state to float precision; Euler
   drifts.

It steps a batch of one nucleus through
``pyqmd_tpu_torch.kernels.forces.force_step``: on the CUDA card that is the
hand-written small-nucleus kernel, one launch per step; with ``--cpu`` the
plain PyTorch step.

    python examples_torch/leapfrog_accuracy.py [--cpu]

Runs on the CUDA card unless ``--cpu`` is given (a few seconds either way).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyqmd_tpu_torch import SimConfig  # noqa: E402
from pyqmd_tpu_torch.kernels.forces import force_step  # noqa: E402
from pyqmd_tpu_torch.state import NEUTRON, PROTON  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch)")
args = parser.parse_args()
DEVICE = torch.device("cpu" if args.cpu else "cuda")

torch.set_num_threads(1)

BASE = dict(z=2, n=2, max_particles=8, damping=1.0)  # undamped dynamics

pos0 = np.zeros((1, 8, 2), np.float32)  # a batch of one nucleus
pos0[0, 0] = (0.0, 0.0)
pos0[0, 1] = (7.0, 0.0)
pos0[0, 2] = (3.5, 6.0)  # smooth attractive regime (no hard-core clamp)
vel0 = np.zeros((1, 8, 2), np.float32)
ptype = torch.tensor([[PROTON, NEUTRON, NEUTRON] + [0] * 5], dtype=torch.int32, device=DEVICE)
alive = torch.tensor([[True] * 3 + [False] * 5], device=DEVICE)


def rollout(cfg, dt, steps, start=None):
    p, v = start or (torch.from_numpy(pos0).to(DEVICE), torch.from_numpy(vel0).to(DEVICE))
    for _ in range(steps):
        p, v = force_step(p, v, ptype, alive, dt, cfg)
    return p, v


def main():
    cfg_e = SimConfig(**BASE, integrator="euler")
    cfg_l = SimConfig(**BASE, integrator="leapfrog")
    t_end, dts = 0.2, [1 / 60, 1 / 120, 1 / 240]

    truth, _ = rollout(cfg_l, t_end / 3840, 3840)
    print("convergence (max position error vs fine-step truth):")
    print(f"  {'dt':>10} {'euler':>12} {'leapfrog':>12}")
    for dt in dts:
        n = round(t_end / dt)
        err_e = float((rollout(cfg_e, dt, n)[0] - truth).abs().max())
        err_l = float((rollout(cfg_l, dt, n)[0] - truth).abs().max())
        print(f"  {dt:10.5f} {err_e:12.3e} {err_l:12.3e}")

    print("\ntime reversibility (|x_roundtrip - x0| after 60 steps out + back):")
    for name, cfg in (("euler", cfg_e), ("leapfrog", cfg_l)):
        p, _ = rollout(cfg, -1 / 120, 60, start=rollout(cfg, 1 / 120, 60))
        drift = float((p.cpu() - torch.from_numpy(pos0)).abs().max())
        print(f"  {name:9s} {drift:.3e}")


if __name__ == "__main__":
    main()
