"""Example: population half-life statistics from a C-14 ensemble.

Runs a 16k-nucleus C-14 ensemble for three half-lives, writes the survival
curve as CSV, and prints the MLE half-life against the tabulated 5,730
years. This is the workflow the reference cannot do at all (one nucleus
per process, nuclear_sim.py:48).

    python examples_torch/survival_curve.py [--cpu]

Runs on the CUDA card (the hand-written decay kernel, one launch per
frame) unless ``--cpu`` is given.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch)")
parser.add_argument("--batch", type=int, default=16384)
args = parser.parse_args()

from pyqmd_tpu_torch.analysis import decay_rate_summary, survival_curve  # noqa: E402

res = survival_curve(
    6, 8, batch=args.batch, frames=30, half_lives=3.0, seed=0,
    device="cpu" if args.cpu else "cuda",
)
with open("c14_survival.csv", "w") as f:
    f.write(res.to_csv())
print(json.dumps(decay_rate_summary(res), indent=2))
print(f"fitted half-life error: {res.rel_error * 100:.2f}%")
print("curve written to c14_survival.csv")
