#!/usr/bin/env python3
"""The control: the plain reference put in the program's place, computed in
the precision below the configuration's float32 (bfloat16 storage of
positions and velocities after every substep of a frame, of half-lives in
a statistics frame). A run of a cell with its control in place has to come out
not correct; its compared numbers are the upper readings the limits are
set below.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <m> ...] --seconds <s>

Prints one JSON line per seed with the compared numbers. The benchmark's
own runs never run this. Each ``patch_*`` function replaces the program's
frame factory in the running process; the sharded cell
applies its patch in every rank.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)

LOWER = "bfloat16"


def _lower():
    import torch

    return getattr(torch, LOWER)


def _full_frame_fn(raw_none: bool = False):
    """A frame factory with the port's signature whose frames are the
    reference's in the lower precision."""
    from benchmark.drivers.sim_frames import as_reference_state
    from benchmark.reference import frame as ref
    from benchmark.reference.config import SimConfig

    def make(cfg, num_steps, batched=False):
        rcfg = SimConfig(**{f: getattr(cfg, f) for f in SimConfig.__dataclass_fields__})

        def frame(state, time_scale, frame_dt, physics_dt=rcfg.effective_dt(),
                  raw_physics_dt=rcfg.physics_dt):
            st, m = ref.full_frame(as_reference_state(state), rcfg, time_scale, frame_dt,
                                   num_steps, physics_dt, None if raw_none else raw_physics_dt,
                                   round_to=_lower())
            if not batched:
                m = {k: v for k, v in m.items() if not k.startswith("total_")}
            return st, m

        return frame

    return make


def patch_frames() -> None:
    """``Simulation``'s frames: the reference's in bfloat16."""
    import pyqmd_tpu_torch.sim as sim

    sim.make_frame_fn = _full_frame_fn()


def patch_survival() -> None:
    """``survival_curve``'s statistics frames: the reference's with
    bfloat16 half-lives."""
    import pyqmd_tpu_torch.analysis as analysis
    from benchmark.drivers.sim_frames import as_reference_state
    from benchmark.reference import frame as ref
    from benchmark.reference.config import SimConfig

    def make(cfg, num_steps):
        rcfg = SimConfig(**{f: getattr(cfg, f) for f in SimConfig.__dataclass_fields__})

        def frame(state, time_scale, frame_dt, *_):
            st = ref.stats_frame(as_reference_state(state), rcfg, time_scale, frame_dt,
                                 num_steps, round_to=_lower())
            return st, {"z": st.z, "n": st.n, "total_decay_counts": st.decay_counts.sum(0)}

        return frame

    analysis.make_decay_frame_fn = make


def patch_sharded() -> None:
    """Each rank's sharded frames: the reference's in bfloat16, the
    aggregates all-reduced as the program reduces them."""
    import pyqmd_tpu_torch.parallel as parallel
    from pyqmd_tpu_torch.parallel.ensemble import sharded_frame

    make = _full_frame_fn(raw_none=True)

    def make_sharded(cfg, num_steps, mesh, axis="data"):
        frame = make(cfg, num_steps, batched=True)
        return sharded_frame(lambda st, ts, fdt: frame(st, ts, fdt, cfg.effective_dt(), None),
                             cfg, mesh, axis)

    parallel.make_sharded_frame_fn = make_sharded


PATCHES = {"sim_frames": patch_frames, "live_view": patch_frames, "survival": patch_survival,
           "sharded_frames": patch_sharded}


def run_control(name: str, seed: int, seconds: float, device: str = "cuda",
                overrides: dict | None = None) -> dict:
    """One run of cell ``name`` with its control in the program's place;
    returns the result line's object."""
    from benchmark import harness
    from benchmark.run import run_cell

    _, workload, _, _ = harness.cell(name)
    driver = dict(workload, **(overrides or {}))["driver"]
    if driver == "sharded_frames":
        return run_cell(name, seed, seconds, False, device=device, t_start=time.perf_counter(),
                        overrides=overrides, patch="benchmark.control:patch_sharded")
    PATCHES[driver]()
    return run_cell(name, seed, seconds, False, device=device, t_start=time.perf_counter(),
                    overrides=overrides)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, action="append", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args()
    from benchmark.run import pin_caches

    pin_caches()
    for seed in args.seed:
        out = run_control(args.workload, seed, args.seconds)
        print(json.dumps({"control": args.workload, "seed": seed, "correct": out["correct"],
                          "numbers": {k: v["value"] for k, v in out["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
