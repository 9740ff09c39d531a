#!/usr/bin/env python3
"""Time the port's force kernel per call on He-4 and U-238 ensembles.

    python3 force_times.py [--tree PATH]

Imports ``pyqmd_tpu_torch`` from PATH (default: the directory of this
file), so that one call on the card can time the kernels of two commits:
unpack the other commit with ``git archive`` under ``.checkouts/`` (which
``.gitignore`` lists) and run this script on it with ``--tree``, in turns
with this tree (other, this, this, other). Each size is timed as the mean
of 20 calls of ``kernels.forces.force_step`` on a fresh ensemble from seed
0, the card held busy while the calls queue (``frame_profile.device_ms``).
A tree whose kernel reads dt from device memory gets dt as the frame
passes it, a 0-d tensor on the card; an older tree's takes a float.
Prints the card's name and power limit, then one JSON line per size.
Without a CUDA device it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

# (isotope, (z, n), pad_to, batch)
SIZES = (
    ("He-4", (2, 2), 8, 10_240),
    ("He-4", (2, 2), 8, 1_048_576),
    ("U-238", (92, 146), 128, 10_240),
    ("U-238", (92, 146), 128, 1_024),
)
DT = 1 / 240.0


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    args = parser.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    from pyqmd_tpu_torch import SimConfig, ensemble_init
    from pyqmd_tpu_torch.frame_profile import device_ms
    from pyqmd_tpu_torch.kernels import _build
    from pyqmd_tpu_torch.kernels.forces import force_step

    if not torch.cuda.is_available():
        print("force_times: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda:0")
    by_pointer = _build.library().pyqmd_force_step.argtypes[8] is ctypes.c_void_p
    dt = torch.full((), DT, device=dev) if by_pointer else DT
    for isotope, (z, n), pad_to, batch in SIZES:
        cfg = SimConfig.for_isotope(z, n, pad_to=pad_to)
        st = ensemble_init(cfg, batch, seed=0, device=dev)
        before, small_before = force_step.launches, getattr(force_step, "small_launches", None)
        paired_before = getattr(force_step, "paired_launches", None)
        ms = device_ms(lambda: force_step(st.pos, st.vel, st.ptype, st.alive, dt, cfg), dev, 20)
        print(json.dumps({"tree": str(tree), "isotope": isotope, "B": batch,
                          "P": cfg.max_particles, "ms_per_call": ms, "dt_by_pointer": by_pointer,
                          "launches": force_step.launches - before,
                          "small_kernel_launches": None if small_before is None
                          else force_step.small_launches - small_before,
                          "paired_launches": None if paired_before is None
                          else force_step.paired_launches - paired_before,
                          "card": card}), flush=True)
        del st
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
