"""Example: watch U-238 walk its decay chain, exporting an animated PNG.

    python examples_torch/decay_chain_movie.py [--cpu]

Produces u238_chain.png (animated) plus the decay log on stdout — the
headless equivalent of the reference's interactive window. Runs on the
CUDA card unless ``--cpu`` is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch)")
parser.add_argument("--frames", type=int, default=240)
args = parser.parse_args()

from pyqmd_tpu_torch import Simulation  # noqa: E402
from pyqmd_tpu_torch.render import write_apng  # noqa: E402

sim = Simulation(z=92, n=146, seed=0, device="cpu" if args.cpu else "cuda")
# 10 billion years per wall-second: this seed walks the complete chain to
# stable Pb-206 inside the default 240 frames (4 wall-seconds of sim).
sim.set_time_scale(3.16e17)

frames = []
for f in range(args.frames):
    sim.frame()
    if f % 8 == 0:
        frames.append(sim.render(480, 360))

write_apng("u238_chain.png", frames, fps=15)
for line in sim.decay_log:
    print(line)
print(f"now {sim.isotope}; wrote u238_chain.png ({len(frames)} frames)")
