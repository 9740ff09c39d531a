"""Example: measured chain populations vs the analytical Bateman solution.

Runs a Pb-214 ensemble through the Pb-214 -> Bi-214 -> Po-214 -> Pb-210
segment of the uranium series and compares the measured isotope
populations at each time point against `bateman_populations` (matrix
exponential of the chain's rate matrix). The reference has neither
ensembles nor any analytical machinery; this is the validation loop the
statistical workflow closes.

    python examples_torch/bateman_vs_ensemble.py [--cpu] [--batch B] [--frames T]

Runs on the CUDA card unless ``--cpu`` is given. Most of its time is the
theory curve: one 1000x1000 matrix exponential on the host per time point,
so ``--frames`` shortens it and ``--batch`` does not.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch)")
parser.add_argument("--batch", type=int, default=8192)
parser.add_argument("--frames", type=int, default=20, help="time points after t = 0")
args = parser.parse_args()

from pyqmd_tpu_torch.analysis import (  # noqa: E402
    bateman_populations,
    chain_populations,
    chain_populations_csv,
)

Z, N = 82, 132  # Pb-214, T1/2 = 1608 s
measured = chain_populations(
    Z, N, batch=args.batch, frames=args.frames, half_lives=3.0,
    device="cpu" if args.cpu else "cuda",
)
theory = bateman_populations(Z, N, np.asarray(measured["times"]))

with open("pb214_measured.csv", "w") as f:
    f.write(chain_populations_csv(measured))
with open("pb214_theory.csv", "w") as f:
    f.write(chain_populations_csv(theory))

print(f"{'isotope':>8} {'measured':>9} {'theory':>9} {'diff':>7}   (final time point)")
worst = 0.0
# Union of keys: a measured member that leaves the predicted graph (the
# 'other' row, or an unpredicted node) counts as a divergence from a
# theory population of 0 — iterating theory keys alone would hide it.
all_keys = set(theory["populations"]) | set(measured["populations"])
for key in sorted(all_keys):
    th = float(theory["populations"].get(key, [0.0])[-1])
    ms = measured["populations"].get(key, [0])[-1] / args.batch
    if th > 0.005 or ms > 0.005:
        print(f"{key:>8} {ms:9.4f} {th:9.4f} {abs(ms - th):7.4f}")
        worst = max(worst, abs(ms - th))
print(f"worst absolute population error: {worst:.4f} "
      f"(statistical sigma ~ {1 / args.batch ** 0.5:.4f})")
print("curves written to pb214_measured.csv / pb214_theory.csv")
