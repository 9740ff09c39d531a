#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing JSON or plain lines; any failure raises and exits
nonzero, and nothing catches it:

1. device and build: the card's name and power limit, and the nvcc build
   of ``pyqmd_tpu_torch/csrc`` with its time and ptxas report;
2. the force kernel against its plain PyTorch version, one step, on U-238
   (P=256), unaligned P=100, He-4 (P=8) and a dense cluster, Euler and
   leapfrog, exact (rtol = atol = 1e-4) and fast-math (atol 5e-3);
3. the overlap kernel against its plain version on the same sizes plus
   coincident pairs (1e-4);
4. the slice at full width: a U-238 ensemble of 10240 nuclei, 3 frames of
   20 substeps at 1e9 years per second, through both kernels, with launch
   counts, decays and NaNs checked, and the rate in nucleus-substeps/s;
   then each kernel's and plain version's time per call at the slice's
   shapes (the plain versions on a sub-batch of 1024 nuclei);
5. the same seed on the CPU (plain versions) and on the card (kernels),
   one frame: integer fields and RNG streams bitwise, pos/vel within 1e-3.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits nonzero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from pyqmd_tpu_torch import SimConfig, ensemble_init, make_frame_fn
from pyqmd_tpu_torch.core import forces as plain_forces
from pyqmd_tpu_torch.core import overlap as plain_overlap
from pyqmd_tpu_torch.kernels import _build
from pyqmd_tpu_torch.kernels.forces import force_step
from pyqmd_tpu_torch.kernels.overlap import overlap_step
from pyqmd_tpu_torch.state import state_to_numpy

DEV = torch.device("cuda:0")
DT = 1 / 240.0
EXACT_TOL = 1e-4  # tests/test_kernel.py:43
FAST_ATOL = 5e-3  # tests/test_kernel.py:165
SLICE_B = 10240
SUB_B = 1024
TIME_SCALE = 3.15576e16  # 1e9 years per wall-second
FRAME_DT = 1 / 60
FRAMES = 3

INT_FIELDS = ("z", "n", "decay_counts", "chain_z0", "chain_n0", "chain_dtype",
              "chain_z1", "chain_n1", "chain_cursor", "rng", "alive", "ptype",
              "ej_type", "ej_alive", "ej_cursor")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def random_batch(p: int, b: int, seed: int, spread: float, alive_frac: float = 0.93):
    g = np.random.default_rng(seed)
    pos = g.uniform(400 - spread / 2, 400 + spread / 2, (b, p, 2)).astype(np.float32)
    vel = g.normal(0, 2, (b, p, 2)).astype(np.float32)
    ptype = g.integers(0, 2, (b, p)).astype(np.int32)
    alive = g.uniform(size=(b, p)) < alive_frac
    u = g.uniform(0, 2 * math.pi, (b, p)).astype(np.float32)
    return [torch.from_numpy(a).to(DEV) for a in (pos, vel, ptype, alive, u)]


def max_diff(a, b) -> float:
    return float((a - b).abs().max())


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one call over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device_and_build() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    log = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    emit({"phase": "build", "seconds": round(build_s, 3), "library": path.name})
    return smi


def phase_force_kernel() -> float:
    """Kernel vs plain, one step; returns the largest exact-mode diff."""
    worst_exact = 0.0
    cases = [
        ("u238", SimConfig.for_isotope(92, 146, pad_to=128), 256, 64, 40.0, 0.93),
        ("p100", SimConfig.for_isotope(26, 30, pad_to=100), 100, 37, 30.0, 0.6),
        ("he4", SimConfig.for_isotope(2, 2, pad_to=8), 8, 1037, 12.0, 0.7),
        ("dense", SimConfig.for_isotope(40, 50, pad_to=128), 128, 16, 4.0, 0.5),
    ]
    for name, base, p, b, spread, frac in cases:
        pos, vel, ptype, alive, _ = random_batch(p, b, seed=p + b, spread=spread, alive_frac=frac)
        for integrator in ("euler", "leapfrog"):
            exact = dataclasses.replace(base, integrator=integrator, fast_math=False)
            fast = dataclasses.replace(exact, fast_math=True)
            ref_p, ref_v = plain_forces.force_step(pos, vel, ptype, alive, DT, exact)
            kp, kv = force_step(pos, vel, ptype, alive, DT, exact)
            fp, fv = force_step(pos, vel, ptype, alive, DT, fast)
            torch.cuda.synchronize()
            tol = 2 * EXACT_TOL if name == "dense" else EXACT_TOL
            torch.testing.assert_close(kp, ref_p, rtol=tol, atol=tol)
            torch.testing.assert_close(kv, ref_v, rtol=tol, atol=tol)
            torch.testing.assert_close(fp, ref_p, rtol=0, atol=FAST_ATOL)
            torch.testing.assert_close(fv, ref_v, rtol=0, atol=FAST_ATOL)
            dead = ~alive
            assert torch.equal(kp[dead], pos[dead]) and torch.equal(kv[dead], vel[dead])
            exact_d = max(max_diff(kp, ref_p), max_diff(kv, ref_v))
            worst_exact = max(worst_exact, exact_d)
            emit({"phase": "force_kernel", "case": name, "integrator": integrator,
                  "B": b, "P": p, "max_abs_diff_exact": exact_d,
                  "max_abs_diff_fast": max(max_diff(fp, ref_p), max_diff(fv, ref_v))})
    return worst_exact


def phase_overlap_kernel() -> float:
    worst = 0.0
    cases = [
        ("u238", SimConfig.for_isotope(92, 146, pad_to=128), 256, 64, 10.0, 0.93),
        ("p100", SimConfig.for_isotope(26, 30, pad_to=100), 100, 37, 8.0, 0.6),
        ("he4", SimConfig.for_isotope(2, 2, pad_to=8), 8, 1037, 4.0, 0.7),
        ("dense", SimConfig.for_isotope(40, 50, pad_to=128), 128, 16, 4.0, 0.5),
        ("coincident", SimConfig.for_isotope(2, 2, pad_to=128), 128, 16, 4.0, 0.0),
    ]
    for name, cfg, p, b, spread, frac in cases:
        pos, _, _, alive, u = random_batch(p, b, seed=7 * p + b, spread=spread, alive_frac=frac)
        if name in ("dense", "coincident"):
            pos[:, :3] = 400.0  # coincident triples take the random direction
            alive[:, :3] = True
        ref = plain_overlap.resolve_overlaps(pos, alive, u, cfg)
        got = overlap_step(pos, alive, u, cfg)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=EXACT_TOL, atol=EXACT_TOL)
        assert torch.equal(got[~alive], pos[~alive])
        if name == "coincident":
            assert float((got[:, 0] - got[:, 1]).norm(dim=-1).min()) > 1.0
        d = max_diff(got, ref)
        worst = max(worst, d)
        emit({"phase": "overlap_kernel", "case": name, "B": b, "P": p, "max_abs_diff": d})
    return worst


def phase_slice(smi: str) -> list:
    cfg = SimConfig.for_isotope(92, 146, pad_to=128)
    steps = cfg.num_substeps(FRAME_DT, TIME_SCALE)
    assert steps == 20, steps
    t0 = time.perf_counter()
    states = ensemble_init(cfg, SLICE_B, seed=0, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    fn = make_frame_fn(cfg, steps, batched=True)
    states, _ = fn(states, TIME_SCALE, FRAME_DT)  # warm-up frame
    torch.cuda.synchronize()

    force_step.launches = 0
    overlap_step.launches = 0
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        states, metrics = fn(states, TIME_SCALE, FRAME_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"force_step": force_step.launches, "overlap_step": overlap_step.launches}

    assert launches["force_step"] == FRAMES * steps, launches
    assert launches["overlap_step"] == FRAMES * cfg.overlap_iterations, launches
    assert not bool(metrics["nan"].any()), "NaN in the ensemble"
    decays = int(metrics["total_decay_counts"].sum())
    assert decays > 0, "no decay fired"
    assert bool(torch.isfinite(states.pos).all()) and states.pos.shape == (SLICE_B, 256, 2)
    rate = SLICE_B * steps * FRAMES / wall
    emit({"phase": "slice", "isotope": "U-238", "B": SLICE_B, "P": cfg.max_particles,
          "frames": FRAMES, "substeps_per_frame": steps, "init_s": round(init_s, 3),
          "wall_s": wall, "nucleus_substeps_per_s": rate, "launches": launches,
          "total_decay_counts": metrics["total_decay_counts"].tolist(),
          "total_alive": int(metrics["total_alive"]), "card": smi})

    # Per-call times at the slice's shapes, the plain versions on a
    # sub-batch of the slice's own state.
    sub = slice(0, SUB_B)
    pos, vel, ptype, alive = states.pos, states.vel, states.ptype, states.alive
    u = torch.rand(pos.shape[:2], device=DEV, generator=torch.Generator(DEV).manual_seed(0)) * 6.0
    k_force_full = cuda_ms(lambda: force_step(pos, vel, ptype, alive, DT, cfg), 5)
    k_force = cuda_ms(lambda: force_step(pos[sub], vel[sub], ptype[sub], alive[sub], DT, cfg), 20)
    p_force = cuda_ms(
        lambda: plain_forces.force_step(pos[sub], vel[sub], ptype[sub], alive[sub], DT, cfg), 5
    )
    k_ov_full = cuda_ms(lambda: overlap_step(pos, alive, u, cfg), 5)
    k_ov = cuda_ms(lambda: overlap_step(pos[sub], alive[sub], u[sub], cfg), 20)
    p_ov = cuda_ms(lambda: plain_overlap.resolve_overlaps(pos[sub], alive[sub], u[sub], cfg), 5)
    kp, kv = force_step(pos[sub], vel[sub], ptype[sub], alive[sub], DT, cfg)
    rp, rv = plain_forces.force_step(pos[sub], vel[sub], ptype[sub], alive[sub], DT, cfg)
    force_err = max(max_diff(kp, rp), max_diff(kv, rv))
    assert force_err <= FAST_ATOL, force_err  # cfg runs fast_math, as the slice does
    ov_err = max_diff(overlap_step(pos[sub], alive[sub], u[sub], cfg),
                      plain_overlap.resolve_overlaps(pos[sub], alive[sub], u[sub], cfg))
    assert ov_err <= EXACT_TOL, ov_err
    emit({"phase": "kernel_times", "card": smi, "sub_batch": SUB_B,
          "force_ms_full_B": k_force_full, "force_ms_sub_B": k_force,
          "force_plain_ms_sub_B": p_force, "overlap_ms_full_B": k_ov_full,
          "overlap_ms_sub_B": k_ov, "overlap_plain_ms_sub_B": p_ov})
    return [
        {"name": "force_step", "route": "cuda", "source": "pyqmd_tpu_torch/csrc/forces.cu",
         "replaces": "pyqmd_tpu/kernels/forces_pallas.py:236",
         "launches": launches["force_step"], "max_abs_err": force_err, "ms": k_force,
         "plain_ms": p_force},
        {"name": "overlap_step", "route": "cuda", "source": "pyqmd_tpu_torch/csrc/overlap.cu",
         "replaces": "pyqmd_tpu/kernels/overlap_pallas.py:38",
         "launches": launches["overlap_step"], "max_abs_err": ov_err, "ms": k_ov,
         "plain_ms": p_ov},
    ]


def phase_cpu_vs_card() -> None:
    for (z, n), b in (((92, 146), 8), ((2, 2), 64)):
        cfg = SimConfig.for_isotope(z, n, pad_to=128 if z > 2 else 8)
        ts = 3.15576e18 if z > 2 else TIME_SCALE
        steps = cfg.num_substeps(FRAME_DT, ts)
        cpu0 = ensemble_init(cfg, b, seed=5)
        card0 = ensemble_init(cfg, b, seed=5, device=DEV)
        a, c = state_to_numpy(cpu0), state_to_numpy(card0)
        for f in INT_FIELDS:
            np.testing.assert_array_equal(c[f], a[f], err_msg=f"init {f}")
        init_pos = float(np.abs(c["pos"] - a["pos"]).max())
        fn = make_frame_fn(cfg, steps, batched=True)
        cpu, cm = fn(cpu0, ts, FRAME_DT)
        card, km = fn(cpu0.to(DEV), ts, FRAME_DT)
        a, c = state_to_numpy(cpu), state_to_numpy(card)
        for f in INT_FIELDS:
            np.testing.assert_array_equal(c[f], a[f], err_msg=f)
        np.testing.assert_allclose(c["pos"], a["pos"], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(c["vel"], a["vel"], rtol=1e-3, atol=1e-3)
        emit({"phase": "cpu_vs_card", "isotope": f"Z{z}N{n}", "B": b, "substeps": steps,
              "decays": int(km["total_decay_counts"].sum()),
              "init_pos_max_abs_diff": init_pos,
              "pos_max_abs_diff": float(np.abs(c["pos"] - a["pos"]).max()),
              "vel_max_abs_diff": float(np.abs(c["vel"] - a["vel"]).max())})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device_and_build()
    phase_force_kernel()
    phase_overlap_kernel()
    kernels = phase_slice(smi)
    phase_cpu_vs_card()
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
