"""Where a frame's time goes, part by part.

    python -m pyqmd_tpu_torch.frame_profile              # every slice, first CUDA card
    python -m pyqmd_tpu_torch.frame_profile u238_full    # named slices only

For each slice that ``chip_smoke.py`` runs: the frame's wall time over five
frames, one frame under ``torch.profiler`` (device kernels, their summed
time, and the card's idle share against the median frame), and the time
of each part of the frame. Prints one JSON line per slice, after the
card's name and power limit. On a CPU device the parts are host times and
no idle share is given.

- ``u238_full``: the full-physics frame of a U-238 ensemble at 10,240
  nuclei, 20 substeps at 1e9 years per second (``make_frame_fn``). Parts:
  the key tree, the ejecta advance and plain decay check of all substeps,
  the force kernel's calls, the overlap pass (its angle draw and kernel
  call) and the metrics.
- ``c14_survival`` and ``u238_chain``: the decay-statistics frame of C-14
  at 2,097,152 nuclei (``analysis.survival_curve``) and U-238 at 65,536
  (``analysis.chain_populations``), both at 10 substeps per frame and the
  8-slot chain ring. Parts: key tree, carry clone, bitfield pack, the
  decay-kernel calls, unpack, metrics.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import step
from pyqmd_tpu_torch.core.decay import maybe_decay, pack_nucleon_bits, unpack_alive_ptype
from pyqmd_tpu_torch.core.init import ensemble_init
from pyqmd_tpu_torch.data.tables import half_life_host
from pyqmd_tpu_torch.kernels.decay import DECAY_FIELDS, decay_stats_substep
from pyqmd_tpu_torch.kernels.forces import force_step

# (name, (z, n), batch, frames, half-lives) of the statistics slices.
SLICES = (
    ("c14_survival", (6, 8), 2_097_152, 20, 2.0),
    ("u238_chain", (92, 146), 65_536, 30, 3.0),
)
# (name, (z, n), pad_to, batch, time scale) of the full-physics slice.
FULL_SLICE = ("u238_full", (92, 146), 128, 10_240, 3.15576e16)
FRAME_DT = 1 / 60


def device_ms(fn, device: torch.device, reps: int = 5) -> float:
    """Mean time of one call of ``fn`` after a warm-up: CUDA events on a
    card, the host clock on a CPU. On the card a spin kernel holds the
    device while the calls are queued, so a call shorter than the host's
    launch time is timed by the device, not by the host's launch rate; a
    part that issues more launches than the spin covers stays host-paced."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def _frame_profile(fn, states, args, device: torch.device):
    """Two warm-up frames, five timed frames and one frame under
    ``torch.profiler``: (the state after the timed frames, their wall
    times in ms, the profiled frame's device kernels, their summed ms or
    None off the card)."""
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    for _ in range(2):
        states, _ = fn(states, *args)
    sync()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        states, _ = fn(states, *args)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        fn(states, *args)
        sync()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 if on_card else None
    return states, walls, len(kernels), kernel_ms


def _summary(cfg, batch, substeps, device, walls, n_kernels, kernel_ms, parts) -> dict:
    median = sorted(walls)[len(walls) // 2]
    return {
        "z": cfg.z, "n": cfg.n, "B": batch, "P": cfg.max_particles, "substeps": substeps,
        "device": str(device), "frame_ms": walls, "profiled_kernels": n_kernels,
        "profiled_kernel_ms": kernel_ms,
        "idle_share": None if kernel_ms is None else 1.0 - kernel_ms / median,
        "parts_ms": parts,
    }


def frame_breakdown(z: int, n: int, batch: int, frames: int, half_lives: float,
                    substeps: int = 10, device="cuda") -> dict:
    """Time one decay-statistics frame of a (z, n) ensemble of ``batch``
    nuclei on ``device`` (the card unless the caller names another),
    stepped at ``analysis.survival_curve``'s frame interval (``half_lives``
    half-lives over ``frames`` frames), after two warm-up frames."""
    device = torch.device(device)
    cfg = SimConfig.for_isotope(z, n, pad_to=8, max_chain_log=8)
    sim_dt = half_lives * half_life_host(z, n) / frames
    fn = step.make_decay_frame_fn(cfg, substeps)
    states, walls, n_kernels, kernel_ms = _frame_profile(
        fn, ensemble_init(cfg, batch, seed=0, device=device), (sim_dt, 1.0), device)

    adv, dyn, _, step_keys = step._batched_frame_preamble(
        states, cfg, sim_dt, 1.0, substeps, cfg.effective_dt(), cfg.physics_dt)
    step_keys = step_keys.contiguous()
    bits = pack_nucleon_bits(adv.alive, adv.ptype)
    # The kernel works in place, so each call of the part (a warm-up and
    # `reps` timed) runs the frame's substeps on a fresh copy of the carry,
    # made before the timing: on one copy, calls after the first would find
    # the frame's decays done and time a substep without them.
    reps = 5
    copies = iter([(adv.replace(**{f: getattr(adv, f).clone() for f in DECAY_FIELDS}),
                    tuple(b.clone() for b in bits)) for _ in range(reps + 1)])

    def decay_substeps():
        carry, cbits = next(copies)
        for k in step_keys:
            decay_stats_substep(carry, cbits, cfg, k, dyn)

    parts = {
        "key_tree": device_ms(lambda: step._batched_frame_preamble(
            states, cfg, sim_dt, 1.0, substeps, cfg.effective_dt(), cfg.physics_dt), device),
        "clone": device_ms(lambda: adv.replace(
            **{f: getattr(adv, f).clone() for f in DECAY_FIELDS}), device),
        "pack": device_ms(lambda: pack_nucleon_bits(adv.alive, adv.ptype), device),
        f"decay_substeps_x{substeps}": device_ms(decay_substeps, device, reps),
        "unpack": device_ms(lambda: unpack_alive_ptype(*bits, cfg.max_particles), device),
        "metrics": device_ms(lambda: step._ensemble_metrics(adv), device),
    }
    return _summary(cfg, batch, substeps, device, walls, n_kernels, kernel_ms, parts)


def full_frame_breakdown(z: int, n: int, batch: int, substeps: int = 20, pad_to: int = 128,
                         time_scale: float = 3.15576e16, device="cuda") -> dict:
    """Time one full-physics frame (``make_frame_fn(cfg, substeps,
    batched=True)``) of a (z, n) ensemble of ``batch`` nuclei on
    ``device`` (the card unless the caller names another), after two
    warm-up frames, and each of its parts on the state they reach."""
    device = torch.device(device)
    cfg = SimConfig.for_isotope(z, n, pad_to=pad_to)
    fn = step.make_frame_fn(cfg, substeps, batched=True)
    states, walls, n_kernels, kernel_ms = _frame_profile(
        fn, ensemble_init(cfg, batch, seed=0, device=device), (time_scale, FRAME_DT), device)

    def preamble():
        return step._batched_frame_preamble(states, cfg, time_scale, FRAME_DT, substeps,
                                            cfg.effective_dt(), cfg.physics_dt)

    adv, dyn, k3, step_keys = preamble()

    def ejecta_and_decay():
        st = adv
        for keys in step_keys:
            st = step.advance_ejecta(st, cfg, dyn)
            st, _ = maybe_decay(st, cfg, keys, dyn)

    def forces():
        pos, vel = adv.pos, adv.vel
        for _ in range(substeps):
            pos, vel = force_step(pos, vel, adv.ptype, adv.alive, dyn.physics_dt, cfg)

    parts = {
        "key_tree": device_ms(preamble, device),
        f"ejecta_decay_x{substeps}": device_ms(ejecta_and_decay, device),
        f"force_kernel_x{substeps}": device_ms(forces, device),
        "overlap": device_ms(lambda: step._batched_overlap(adv.pos, adv.alive, k3[:, 1], cfg),
                             device),
        "metrics": device_ms(lambda: step._ensemble_metrics(adv), device),
    }
    return _summary(cfg, batch, substeps, device, walls, n_kernels, kernel_ms, parts)


def main(names: list[str]) -> int:
    if not torch.cuda.is_available():
        print("frame_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    name, (z, n), pad_to, batch, time_scale = FULL_SLICE
    if not names or name in names:
        out = full_frame_breakdown(z, n, batch, pad_to=pad_to, time_scale=time_scale)
        print(json.dumps({"slice": name, **out, "card": card}), flush=True)
        torch.cuda.empty_cache()
    for name, (z, n), batch, frames, half_lives in SLICES:
        if names and name not in names:
            continue
        out = frame_breakdown(z, n, batch, frames, half_lives)
        print(json.dumps({"slice": name, **out, "card": card}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
