"""Example: a heterogeneous sample decaying on multiple clocks.

Builds one ensemble holding Rn-222 (3.8-day alpha emitter), C-14
(5,730-year beta emitter) and stable He-4, runs it for two Rn-222
half-lives, and prints the isotope populations over time — two features the
reference cannot express (one nucleus per process, one isotope at a time).

    python examples_torch/mixed_population.py [--cpu]

Runs on the CUDA card (the force and overlap kernels, every frame) unless
``--cpu`` is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch)")
parser.add_argument(
    "--quick", action="store_true",
    help="tiny population + fewer frames (used by the example smoke test)",
)
args = parser.parse_args()

import torch  # noqa: E402

from pyqmd_tpu_torch import SimConfig, make_frame_fn, mixed_ensemble_init  # noqa: E402
from pyqmd_tpu_torch.data.elements import isotope_label  # noqa: E402

RN222_HL = 3.8235 * 86400.0

cfg = SimConfig.for_isotope(86, 136, pad_to=8)  # capacity sized for Rn-222
species = (
    [(86, 136, 32), (6, 8, 32), (2, 2, 8)]
    if args.quick
    else [(86, 136, 256), (6, 8, 256), (2, 2, 64)]
)
states = mixed_ensemble_init(cfg, species, seed=0, device="cpu" if args.cpu else "cuda")
fn = make_frame_fn(cfg, 10, batched=True)

sim_dt = 0.25 * RN222_HL  # quarter Rn-222 half-life per frame
print(f"{'t / T(Rn-222)':>14}  populations")
for f in range(5 if args.quick else 9):
    if f:
        states, m = fn(states, sim_dt, 1.0)
    # (Z, N) of every member in one transfer.
    zn = torch.stack([states.z, states.n], 1).cpu().numpy()
    counts = {}
    for z, n in zn:
        counts[isotope_label(z, n)] = counts.get(isotope_label(z, n), 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:6]
    print(f"{f * 0.25:>14.2f}  " + "  ".join(f"{k}:{v}" for k, v in top))
print("\nRn-222 decays toward its chain (Po-218 -> Pb-214 -> ...) on a days")
print("clock; C-14 and He-4 are effectively frozen at this time scale.")
