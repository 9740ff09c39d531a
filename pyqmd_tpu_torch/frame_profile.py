"""Where the decay-statistics frame's time goes, part by part.

    python -m pyqmd_tpu_torch.frame_profile        # on the first CUDA card

For each statistics slice that ``chip_smoke.py`` runs, C-14 at 2,097,152
nuclei (``analysis.survival_curve``) and U-238 at 65,536 (``analysis.
chain_populations``), both at 10 substeps per frame and the 8-slot chain
ring: the frame's wall time over five frames, one frame under
``torch.profiler`` (device kernels, their summed time, and the card's idle
share against the median frame), and the time of each part of the frame
(key tree, carry clone, bitfield pack, the decay-kernel calls, unpack,
metrics). Prints one JSON line per slice, after the card's name and power
limit. On a CPU device the parts are host times and no idle share is
given.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import step
from pyqmd_tpu_torch.core.decay import pack_nucleon_bits, unpack_alive_ptype
from pyqmd_tpu_torch.core.init import ensemble_init
from pyqmd_tpu_torch.data.tables import half_life_host
from pyqmd_tpu_torch.kernels.decay import DECAY_FIELDS, decay_stats_substep

# (name, (z, n), batch, frames, half-lives) of the statistics slices.
SLICES = (
    ("c14_survival", (6, 8), 2_097_152, 20, 2.0),
    ("u238_chain", (92, 146), 65_536, 30, 3.0),
)


def device_ms(fn, device: torch.device, reps: int = 5) -> float:
    """Mean time of one call of ``fn`` after a warm-up: CUDA events on a
    card, the host clock on a CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def frame_breakdown(z: int, n: int, batch: int, frames: int, half_lives: float,
                    substeps: int = 10, device="cpu") -> dict:
    """Time one decay-statistics frame of a (z, n) ensemble of ``batch``
    nuclei stepped at ``analysis.survival_curve``'s frame interval
    (``half_lives`` half-lives over ``frames`` frames), after two warm-up
    frames."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    cfg = SimConfig.for_isotope(z, n, pad_to=8, max_chain_log=8)
    sim_dt = half_lives * half_life_host(z, n) / frames
    states = ensemble_init(cfg, batch, seed=0, device=device)
    fn = step.make_decay_frame_fn(cfg, substeps)
    for _ in range(2):
        states, _ = fn(states, sim_dt, 1.0)
    sync()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        states, _ = fn(states, sim_dt, 1.0)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        fn(states, sim_dt, 1.0)
        sync()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    median = sorted(walls)[len(walls) // 2]

    adv, dyn, _, step_keys = step._batched_frame_preamble(
        states, cfg, sim_dt, 1.0, substeps, cfg.effective_dt(), cfg.physics_dt)
    step_keys = step_keys.contiguous()
    bits = pack_nucleon_bits(adv.alive, adv.ptype)
    carry = adv.replace(**{f: getattr(adv, f).clone() for f in DECAY_FIELDS})
    parts = {
        "key_tree": device_ms(lambda: step._batched_frame_preamble(
            states, cfg, sim_dt, 1.0, substeps, cfg.effective_dt(), cfg.physics_dt), device),
        "clone": device_ms(lambda: adv.replace(
            **{f: getattr(adv, f).clone() for f in DECAY_FIELDS}), device),
        "pack": device_ms(lambda: pack_nucleon_bits(adv.alive, adv.ptype), device),
        f"decay_substeps_x{substeps}": device_ms(
            lambda: [decay_stats_substep(carry, bits, cfg, k, dyn) for k in step_keys], device),
        "unpack": device_ms(lambda: unpack_alive_ptype(*bits, cfg.max_particles), device),
        "metrics": device_ms(lambda: step._ensemble_metrics(adv), device),
    }
    return {
        "z": z, "n": n, "B": batch, "P": cfg.max_particles, "substeps": substeps,
        "device": str(device), "frame_ms": walls,
        "profiled_kernels": len(kernels), "profiled_kernel_ms": kernel_ms if on_card else None,
        "idle_share": 1.0 - kernel_ms / median if on_card else None,
        "parts_ms": parts,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("frame_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for name, (z, n), batch, frames, half_lives in SLICES:
        out = frame_breakdown(z, n, batch, frames, half_lives, device="cuda")
        print(json.dumps({"slice": name, **out, "card": card}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
