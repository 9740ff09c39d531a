#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing JSON or plain lines; any failure raises and exits
nonzero, and nothing catches it:

1. device and build: the card's name and power limit, and the nvcc build
   of ``pyqmd_tpu_torch/csrc`` with its time and ptxas report;
2. the force kernel against its plain PyTorch version, one step, on U-238
   (P=256), unaligned P=100 and P=33, He-4 (P=8), a dense cluster and
   P=2000, Euler and leapfrog, exact (rtol = atol = 1e-4) and fast-math
   (atol 5e-3), and two launches on the same input bitwise equal;
3. the overlap kernel against its plain version on the same sizes plus
   coincident pairs (1e-4), two launches bitwise equal;
4. the slice at full width: a U-238 ensemble of 10240 nuclei, 3 frames of
   20 substeps at 1e9 years per second, through both kernels, with launch
   counts, decays and NaNs checked, and the rate in nucleus-substeps/s;
   then each kernel's and plain version's time per call at the slice's
   shapes (the plain versions on a sub-batch of 1024 nuclei) and at He-4
   B=10240, each beside its bound (below) and its launches per frame;
5. the same seed on the CPU (plain versions) and on the card (kernels),
   one frame: integer fields and RNG streams bitwise, pos/vel within 1e-3;
6. the decay-statistics kernel against its plain PyTorch version on the
   card, one substep each of C-14 (B=65536), Pb-214 (B=4099), U-238 at
   P=240 (B=1024) and a U-238 + C-14 mixture, then 25 chained Pb-214
   substeps: integer fields and bitfield words bitwise, half-lives and
   times within 1e-6 relative;
7. the statistics slice at full width: ``analysis.survival_curve`` of C-14
   at 2,097,152 nuclei (20 frames of 10 substeps; fit within 1% of 5,730
   years, 200 kernel launches) and ``analysis.chain_populations`` of U-238
   at 65,536 nuclei (every member's alive and ptype agree with its decay
   counts; the populations beside the Bateman curve). At both sizes, with
   the 8-slot chain ring the path runs, the decay kernel is held to its
   plain version on the frame's next substep (for U-238 with members whose
   ring wraps), and at the C-14 size both are timed per call over a
   frame's chained substeps;
8. the same seed through the statistics frame on the CPU and on the card,
   C-14 B=4096 and U-238 B=64: integer fields and RNG streams bitwise,
   floats within 1e-6 relative.

A kernel's bound is the least time the card could take for the same work,
from this run's inputs: the larger of the bytes it must move (each input
read once, each output written once) over 3.35 TB/s and its operations
over their peak (f32 67 TFLOP/s; the special-function unit 16 per SM per
clock x 132 SMs x 1.98 GHz; int32 half the f32 rate). The force law counts
40 flops and 3 transcendentals per pair (the JAX package's cost model,
``forces_pallas.py:474, 485``).

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

from pyqmd_tpu_torch import (
    SimConfig,
    analysis,
    ensemble_init,
    make_decay_frame_fn,
    make_frame_fn,
    mixed_ensemble_init,
    prng,
)
from pyqmd_tpu_torch.core import decay as plain_decay
from pyqmd_tpu_torch.core import forces as plain_forces
from pyqmd_tpu_torch.core import overlap as plain_overlap
from pyqmd_tpu_torch.core import step
from pyqmd_tpu_torch.core.dynamics import FrameDynamics
from pyqmd_tpu_torch.frame_profile import device_ms
from pyqmd_tpu_torch.kernels import _build
from pyqmd_tpu_torch.kernels.decay import DECAY_FIELDS, decay_stats_substep
from pyqmd_tpu_torch.kernels.forces import force_step
from pyqmd_tpu_torch.kernels.overlap import overlap_step
from pyqmd_tpu_torch.state import DECAY_ALPHA, DECAY_BETA_MINUS, DECAY_BETA_PLUS, PROTON
from pyqmd_tpu_torch.state import DECAY_NEUTRON_EMISSION, DECAY_PROTON_EMISSION
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
STATS_FLOATS = ("half_life", "last_decay_time", "chain_time")
STATS_REL_TOL = 1e-6
C14_B = 2_097_152  # the README's 2M-nucleus C-14 statistics
U238_CHAIN_B = 65_536

# Published H100 SXM peaks (NVIDIA's data sheet and Hopper white paper).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SFU_OPS = 16 * 132 * 1.98e9
INT32_OPS = F32_FLOPS / 2
FORCE_FLOPS_PER_PAIR, FORCE_SFU_PER_PAIR = 40, 3  # forces_pallas.py:474, 485
FORCE_BYTES_PER_SLOT = 37  # pos, vel, ptype, alive in; pos, vel out
OVERLAP_BYTES_PER_SLOT = 21  # pos, alive, u in; pos out
THREEFRY_INT_OPS = 80  # 20 rounds of add, rotate, xor plus 5 key injections


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


def rel_err(a, b) -> float:
    """Largest relative difference of two float arrays, inf == inf."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    rel[same] = 0.0
    return float(rel.max(initial=0.0))


def bound(nbytes: float, flops: float = 0.0, sfu: float = 0.0, int_ops: float = 0.0) -> dict:
    """The least time for the work: bytes over the memory rate or
    operations over their peak, whichever is larger."""
    ms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "flops": flops / F32_FLOPS * 1e3,
          "sfu": sfu / SFU_OPS * 1e3, "int32": int_ops / INT32_OPS * 1e3}
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_set_by": by, "bound_parts_ms": ms}


def alive_pairs(alive) -> int:
    a = alive.sum(-1).double()
    return int((a * (a - 1) / 2).sum())


def force_bound(alive, sweeps: int = 1) -> dict:
    pairs = alive_pairs(alive) * sweeps
    return bound(alive.numel() * FORCE_BYTES_PER_SLOT, flops=FORCE_FLOPS_PER_PAIR * pairs,
                 sfu=FORCE_SFU_PER_PAIR * pairs)


def overlap_bound(pos, alive, md2: float) -> tuple[dict, int]:
    """Every alive pair takes the range test (~6 flops); a pair in range
    adds the push (~15 flops, a sqrt and two divisions); every slot takes
    a cos and a sin. Returns the bound and the pairs in range."""
    in_range = 0
    for s in range(0, pos.shape[0], 512):
        p, a = pos[s:s + 512], alive[s:s + 512]
        d = p[:, None] - p[:, :, None]
        both = a[:, None] & a[:, :, None] & torch.ones(
            a.shape[1], a.shape[1], dtype=torch.bool, device=a.device).triu(1)
        in_range += int(((d * d).sum(-1) < md2)[both].sum())
    pairs = alive_pairs(alive)
    return bound(alive.numel() * OVERLAP_BYTES_PER_SLOT, flops=6 * pairs + 15 * in_range,
                 sfu=3 * in_range + 2 * alive.numel()), in_range


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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    emit({"phase": "build", "seconds": round(build_s, 3), "library": path.name})
    return smi


def phase_force_kernel() -> float:
    """Kernel vs plain, one step; returns the largest exact-mode diff."""
    worst_exact = 0.0
    cases = [
        ("u238", SimConfig.for_isotope(92, 146, pad_to=128), 256, 64, 40.0, 0.93),
        ("p100", SimConfig.for_isotope(26, 30, pad_to=100), 100, 37, 30.0, 0.6),
        ("p33", SimConfig.for_isotope(15, 18, pad_to=33), 33, 101, 25.0, 0.9),
        ("he4", SimConfig.for_isotope(2, 2, pad_to=8), 8, 1037, 12.0, 0.7),
        ("dense", SimConfig.for_isotope(40, 50, pad_to=128), 128, 16, 4.0, 0.5),
        ("p2000", SimConfig.for_isotope(92, 146, pad_to=2000), 2000, 4, 150.0, 0.9),
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
            for cfg, (op, ov) in ((exact, (kp, kv)), (fast, (fp, fv))):
                again = force_step(pos, vel, ptype, alive, DT, cfg)
                assert torch.equal(again[0], op) and torch.equal(again[1], ov), (name, cfg)
            exact_d = max(max_diff(kp, ref_p), max_diff(kv, ref_v))
            worst_exact = max(worst_exact, exact_d)
            emit({"phase": "force_kernel", "case": name, "integrator": integrator,
                  "B": b, "P": p, "max_abs_diff_exact": exact_d,
                  "max_abs_diff_fast": max(max_diff(fp, ref_p), max_diff(fv, ref_v)),
                  "relaunch_bitwise": True})
    return worst_exact


def phase_overlap_kernel() -> float:
    worst = 0.0
    cases = [
        ("u238", SimConfig.for_isotope(92, 146, pad_to=128), 256, 64, 10.0, 0.93),
        ("p100", SimConfig.for_isotope(26, 30, pad_to=100), 100, 37, 8.0, 0.6),
        ("p33", SimConfig.for_isotope(15, 18, pad_to=33), 33, 101, 8.0, 0.9),
        ("he4", SimConfig.for_isotope(2, 2, pad_to=8), 8, 1037, 4.0, 0.7),
        ("dense", SimConfig.for_isotope(40, 50, pad_to=128), 128, 16, 4.0, 0.5),
        ("coincident", SimConfig.for_isotope(2, 2, pad_to=128), 128, 16, 4.0, 0.0),
        ("p2000", SimConfig.for_isotope(92, 146, pad_to=2000), 2000, 4, 150.0, 0.9),
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
        assert torch.equal(overlap_step(pos, alive, u, cfg), got), name
        if name == "coincident":
            assert float((got[:, 0] - got[:, 1]).norm(dim=-1).min()) > 1.0
        d = max_diff(got, ref)
        worst = max(worst, d)
        emit({"phase": "overlap_kernel", "case": name, "B": b, "P": p, "max_abs_diff": d,
              "relaunch_bitwise": True})
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
    # sub-batch of the slice's own state; each beside its bound.
    sub = slice(0, SUB_B)
    pos, vel, ptype, alive = states.pos, states.vel, states.ptype, states.alive
    u = torch.rand(pos.shape[:2], device=DEV, generator=torch.Generator(DEV).manual_seed(0)) * 6.0
    k_force_full = device_ms(lambda: force_step(pos, vel, ptype, alive, DT, cfg), DEV, 20)
    k_force = device_ms(
        lambda: force_step(pos[sub], vel[sub], ptype[sub], alive[sub], DT, cfg), DEV, 20
    )
    p_force = device_ms(
        lambda: plain_forces.force_step(pos[sub], vel[sub], ptype[sub], alive[sub], DT, cfg), DEV, 5
    )
    k_ov_full = device_ms(lambda: overlap_step(pos, alive, u, cfg), DEV, 20)
    k_ov = device_ms(lambda: overlap_step(pos[sub], alive[sub], u[sub], cfg), DEV, 20)
    p_ov = device_ms(
        lambda: plain_overlap.resolve_overlaps(pos[sub], alive[sub], u[sub], cfg), DEV, 5
    )
    kp, kv = force_step(pos[sub], vel[sub], ptype[sub], alive[sub], DT, cfg)
    rp, rv = plain_forces.force_step(pos[sub], vel[sub], ptype[sub], alive[sub], DT, cfg)
    force_err = max(max_diff(kp, rp), max_diff(kv, rv))
    assert force_err <= FAST_ATOL, force_err  # cfg runs fast_math, as the slice does
    ov_err = max_diff(overlap_step(pos[sub], alive[sub], u[sub], cfg),
                      plain_overlap.resolve_overlaps(pos[sub], alive[sub], u[sub], cfg))
    assert ov_err <= EXACT_TOL, ov_err
    md2 = cfg.overlap_min_dist ** 2
    fb_full, fb_sub = force_bound(alive), force_bound(alive[sub])
    (ob_full, in_range), (ob_sub, _) = overlap_bound(pos, alive, md2), overlap_bound(
        pos[sub], alive[sub], md2)

    # He-4 at the slice's batch: the small-nucleus case of the same kernel.
    he4 = SimConfig.for_isotope(2, 2, pad_to=8)
    he = ensemble_init(he4, SLICE_B, seed=0, device=DEV)
    k_he4 = device_ms(lambda: force_step(he.pos, he.vel, he.ptype, he.alive, DT, he4), DEV, 20)
    p_he4 = device_ms(
        lambda: plain_forces.force_step(he.pos, he.vel, he.ptype, he.alive, DT, he4), DEV, 5)
    he4_err = max(max_diff(a, b) for a, b in zip(
        force_step(he.pos, he.vel, he.ptype, he.alive, DT, he4),
        plain_forces.force_step(he.pos, he.vel, he.ptype, he.alive, DT, he4)))
    assert he4_err <= FAST_ATOL, he4_err
    fb_he4 = force_bound(he.alive)

    def share(b, ms):
        return b["bound_ms"] / ms

    emit({"phase": "kernel_times", "card": smi, "B": SLICE_B, "sub_batch": SUB_B,
          "force": {"launches_per_frame": steps, "ms_full_B": k_force_full,
                    "bound_full_B": fb_full, "share_full_B": share(fb_full, k_force_full),
                    "ms_sub_B": k_force, "plain_ms_sub_B": p_force, "bound_sub_B": fb_sub,
                    "alive_pairs_full_B": alive_pairs(alive),
                    "simple_form_ms_full_B_pr1": 3.86},
          "overlap": {"launches_per_frame": cfg.overlap_iterations, "ms_full_B": k_ov_full,
                      "bound_full_B": ob_full, "share_full_B": share(ob_full, k_ov_full),
                      "ms_sub_B": k_ov, "plain_ms_sub_B": p_ov, "bound_sub_B": ob_sub,
                      "pairs_in_range_full_B": in_range,
                      "simple_form_ms_full_B_pr1": 1.62},
          "force_he4": {"launches_per_frame": he4.num_substeps(FRAME_DT, TIME_SCALE),
                        "B": SLICE_B, "P": 8, "ms": k_he4, "plain_ms": p_he4, "bound": fb_he4,
                        "share": share(fb_he4, k_he4), "max_abs_err": he4_err,
                        "simple_form_ms_pr1": 0.061}})
    return [
        {"name": "force_step", "route": "cuda", "source": "pyqmd_tpu_torch/csrc/forces.cu",
         "replaces": "pyqmd_tpu/kernels/forces_pallas.py:236",
         "launches": launches["force_step"], "max_abs_err": force_err, "ms": k_force,
         "plain_ms": p_force, "bound_ms": fb_sub["bound_ms"], "bound_by": fb_sub["bound_by"],
         "library_ms": None, "B": SUB_B, "ms_full_B": k_force_full,
         "bound_ms_full_B": fb_full["bound_ms"]},
        {"name": "overlap_step", "route": "cuda", "source": "pyqmd_tpu_torch/csrc/overlap.cu",
         "replaces": "pyqmd_tpu/kernels/overlap_pallas.py:38",
         "launches": launches["overlap_step"], "max_abs_err": ov_err, "ms": k_ov,
         "plain_ms": p_ov, "bound_ms": ob_sub["bound_ms"], "bound_by": ob_sub["bound_by"],
         "library_ms": None, "B": SUB_B, "ms_full_B": k_ov_full,
         "bound_ms_full_B": ob_full["bound_ms"]},
    ]


def phase_cpu_vs_card() -> None:
    for (z, n), b in (((92, 146), 8), ((2, 2), 64)):
        cfg = SimConfig.for_isotope(z, n, pad_to=128 if z > 2 else 8)
        ts = 3.15576e18 if z > 2 else TIME_SCALE
        steps = cfg.num_substeps(FRAME_DT, ts)
        cpu0 = ensemble_init(cfg, b, seed=5, device="cpu")
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


def _stats_dyn(cfg, step_time) -> FrameDynamics:
    return FrameDynamics(np.float32(1.0), np.float32(1.0), np.float32(cfg.effective_dt()),
                         np.float32(step_time), None)


def _compare_stats(want, want_bits, got, got_bits, what: str) -> tuple[float, float]:
    """Integer fields and bitfield words bitwise, floats within
    STATS_REL_TOL; returns (max abs, max relative) difference."""
    for f in DECAY_FIELDS:
        if f not in STATS_FLOATS:
            a, b = getattr(got, f), getattr(want, f)
            diff = torch.nonzero((a != b).reshape(a.shape[0], -1).any(-1)).flatten()
            assert diff.numel() == 0, f"{what}: {f} differs for members {diff[:10].tolist()}"
    for i, (a, b) in enumerate(zip(got_bits, want_bits)):
        assert torch.equal(a, b), f"{what}: bitfield {i} differs"
    w = {f: getattr(want, f).cpu().numpy() for f in STATS_FLOATS}
    g = {f: getattr(got, f).cpu().numpy() for f in STATS_FLOATS}
    rel = max(rel_err(g[f], w[f]) for f in STATS_FLOATS)
    assert rel <= STATS_REL_TOL, (what, rel)
    finite = [np.isfinite(w[f]) & np.isfinite(g[f]) for f in STATS_FLOATS]
    abs_d = max(float(np.abs(g[f][m] - w[f][m]).max(initial=0.0))
                for f, m in zip(STATS_FLOATS, finite))
    return abs_d, rel


def _clone_carry(states, bits):
    return (states.replace(**{f: getattr(states, f).clone() for f in DECAY_FIELDS}),
            tuple(x.clone() for x in bits))


def _kernel_vs_plain(states, cfg, keys, dyn, what):
    """One substep by the kernel (on a clone) and by the plain version;
    returns (max abs, max rel) difference, the mask of members that
    decayed, and their alpha decays."""
    bits = plain_decay.pack_nucleon_bits(states.alive, states.ptype)
    want, _, want_bits = plain_decay.maybe_decay(states, cfg, keys, dyn, stats_only=True,
                                                 packed_nucleons=bits)
    got, got_bits = _clone_carry(states, bits)
    decay_stats_substep(got, got_bits, cfg, keys, dyn)
    torch.cuda.synchronize()
    abs_d, rel = _compare_stats(want, want_bits, got, got_bits, what)
    alphas = int((got.decay_counts - states.decay_counts)[:, DECAY_ALPHA].sum())
    return abs_d, rel, got.chain_cursor != states.chain_cursor, alphas


def _next_substep_inputs(states, cfg, sim_dt, substeps):
    """The state, dynamics and substep keys that the statistics frame
    hands its next kernel calls."""
    states, dyn, _, step_keys = step._batched_frame_preamble(
        states, cfg, sim_dt, 1.0, substeps, cfg.effective_dt(), cfg.physics_dt)
    return states, dyn, step_keys.contiguous()


def _main_path_check(states, cfg, sim_dt, what, worst) -> dict:
    """Kernel vs plain on the main path's own next substep: its batch, its
    chain ring, its keys and clock. Raises on a difference; returns what
    was compared, and the decays that wrote past the ring's end."""
    adv, dyn, step_keys = _next_substep_inputs(states, cfg, sim_dt, 10)
    abs_d, rel, fired, _ = _kernel_vs_plain(adv, cfg, step_keys[0], dyn, what)
    worst[0], worst[1] = max(worst[0], abs_d), max(worst[1], rel)
    wrapped = int((fired & (adv.chain_cursor >= cfg.max_chain_log)).sum())
    return {"phase": "decay_kernel", "case": what, "B": adv.batch, "P": cfg.max_particles,
            "C": cfg.max_chain_log, "decays": int(fired.sum()), "ring_wrap_decays": wrapped,
            "max_abs_diff": abs_d, "max_rel_diff": rel}


def substep_ms(adv, bits, cfg, step_keys, dyn, kernel: bool, reps: int) -> list[float]:
    """Device time per substep call, over the S chained substeps of one
    frame, each rep on a fresh copy of the carry, so every call sees the
    frame's real share of decays. The card is held busy while the calls
    are queued, so host gaps between launches are not timed."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for r in range(reps + 1):  # rep 0 warms up
        carry, cbits = _clone_carry(adv, bits)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        for keys in step_keys:
            if kernel:
                decay_stats_substep(carry, cbits, cfg, keys, dyn)
            else:
                carry, _, cbits = plain_decay.maybe_decay(carry, cfg, keys, dyn,
                                                          stats_only=True, packed_nucleons=cbits)
        end.record()
        torch.cuda.synchronize()
        if r:
            out.append(start.elapsed_time(end) / len(step_keys))
    return out


def phase_decay_kernel() -> tuple[float, float]:
    """Decay kernel vs plain on the card; returns the worst (abs, rel)."""
    worst = [0.0, 0.0]
    u238 = SimConfig.for_isotope(92, 146, pad_to=8)
    cases = [
        ("c14", SimConfig.for_isotope(6, 8, pad_to=8), None, 65_536, 1e11),
        ("pb214", SimConfig.for_isotope(82, 132, pad_to=8), None, 4_099, 1e3),
        ("u238", u238, None, 1_024, 1e17),
        ("u238+c14", u238, [(92, 146, 2_048), (6, 8, 2_048)], 4_096, 1e17),
    ]
    for name, cfg, species, b, step_time in cases:
        if species:
            states = mixed_ensemble_init(cfg, species, seed=1, device=DEV)
        else:
            states = ensemble_init(cfg, b, seed=1, device=DEV)
        # A clock that makes the measured durations nonzero for half the batch.
        tp_ = torch.full((b,), 3.0 * step_time, device=DEV)
        states = states.replace(time_passed=tp_, last_decay_time=torch.where(
            torch.arange(b, device=DEV) % 2 == 0, 0.0, tp_))
        keys = prng.split(prng.prng_key(b, device=DEV), b)
        abs_d, rel, fired, alphas = _kernel_vs_plain(states, cfg, keys, _stats_dyn(cfg, step_time),
                                                     name)
        fired = int(fired.sum())
        assert fired > b // 10, (name, fired)
        if name.startswith("u238"):
            assert alphas > 0, name
        worst = [max(worst[0], abs_d), max(worst[1], rel)]
        emit({"phase": "decay_kernel", "case": name, "B": b, "P": cfg.max_particles,
              "W": -(-cfg.max_particles // 32), "decays": fired, "max_abs_diff": abs_d,
              "max_rel_diff": rel})

    # 25 chained substeps of Pb-214 (beta into beta), each side on its own carry.
    cfg = SimConfig.for_isotope(82, 132, pad_to=8)
    b = 4_099
    states = ensemble_init(cfg, b, seed=0, device=DEV)
    dyn = _stats_dyn(cfg, np.float32(3e5 / 60 / 6))
    ref = states.replace(**{f: getattr(states, f).clone() for f in DECAY_FIELDS})
    ker = states.replace(**{f: getattr(states, f).clone() for f in DECAY_FIELDS})
    ref_bits = plain_decay.pack_nucleon_bits(states.alive, states.ptype)
    ker_bits = tuple(x.clone() for x in ref_bits)
    key = prng.prng_key(3, device=DEV)
    for s in range(25):
        keys = prng.split(prng.fold_in(key[None], s), b)[0]
        ref, _, ref_bits = plain_decay.maybe_decay(ref, cfg, keys, dyn, stats_only=True,
                                                   packed_nucleons=ref_bits)
        decay_stats_substep(ker, ker_bits, cfg, keys, dyn)
        ref = ref.replace(time_passed=ref.time_passed + float(dyn.step_time))
        ker = ker.replace(time_passed=ker.time_passed + float(dyn.step_time))
    torch.cuda.synchronize()
    abs_d, rel = _compare_stats(ref, ref_bits, ker, ker_bits, "pb214 chained")
    decays = int(ker.decay_counts.sum())
    assert decays > b, decays
    worst = [max(worst[0], abs_d), max(worst[1], rel)]
    emit({"phase": "decay_kernel", "case": "pb214_chained_25", "B": b, "decays": decays,
          "max_abs_diff": abs_d, "max_rel_diff": rel})
    return worst[0], worst[1]


def phase_stats_slice(smi: str, worst: tuple[float, float]) -> dict:
    """The statistics slice at full width, through the analysis entry points."""
    decay_stats_substep.launches = 0
    t0 = time.perf_counter()
    res = analysis.survival_curve(6, 8, batch=C14_B, frames=20, half_lives=2.0, substeps=10,
                                  seed=0, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = decay_stats_substep.launches
    assert launches == 200, launches
    assert res.rel_error < 0.01, res.rel_error
    assert np.all(np.diff(res.survival) <= 0) and res.survival.shape == (21,)
    emit({"phase": "stats_slice", "case": "c14_survival", "B": C14_B, "frames": 20,
          "substeps_per_frame": 10, "launches": launches, "wall_s": wall,
          "nucleus_substeps_per_s_incl_init": C14_B * 200 / wall,
          "fitted_half_life_years": res.fitted_half_life / 3.15576e7,
          "tabulated_half_life_years": res.tabulated_half_life / 3.15576e7,
          "rel_error": res.rel_error, "final_survival": float(res.survival[-1]),
          "decay_counts": res.decay_counts.tolist(), "card": smi})

    # The frame loop alone, on an ensemble built outside the timed window.
    cfg = SimConfig.for_isotope(6, 8, pad_to=8, max_chain_log=8)
    torch.cuda.reset_peak_memory_stats()
    states = ensemble_init(cfg, C14_B, seed=0, device=DEV)
    fn = make_decay_frame_fn(cfg, 10)
    sim_dt = 2.0 * res.tabulated_half_life / 20
    states, _ = fn(states, sim_dt, 1.0)  # warm-up frame
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        states, m = fn(states, sim_dt, 1.0)
    torch.cuda.synchronize()
    frames_s = time.perf_counter() - t0
    emit({"phase": "stats_slice", "case": "c14_frames", "B": C14_B, "frames": 10,
          "wall_s": frames_s, "ms_per_frame": frames_s * 100.0,
          "nucleus_substeps_per_s": C14_B * 100 / frames_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})

    # Kernel vs plain at the main path's size (B=2M, the 8-slot chain ring),
    # on the inputs of the frame's next substep (the state after 11 frames).
    worst = list(worst)
    c14_check = _main_path_check(states, cfg, sim_dt, "c14_main_path", worst)
    assert c14_check["decays"] > 1000, c14_check
    emit(c14_check)

    # Per call over the next frame's 10 substeps, each rep from a fresh carry.
    adv, dyn, step_keys = _next_substep_inputs(states, cfg, sim_dt, 10)
    bits = plain_decay.pack_nucleon_bits(adv.alive, adv.ptype)
    kernel_runs = substep_ms(adv, bits, cfg, step_keys, dyn, kernel=True, reps=10)
    plain_runs = substep_ms(adv, bits, cfg, step_keys, dyn, kernel=False, reps=3)
    kernel_ms, plain_ms = float(np.mean(kernel_runs)), float(np.mean(plain_runs))
    # Bound over the same calls: every nucleus reads its half-life and key
    # (20 bytes) and hashes one threefry; a decay adds ~40 + 16 W bytes
    # (decay.cu) and three more hashes.
    carry, cbits = _clone_carry(adv, bits)
    for keys in step_keys:
        decay_stats_substep(carry, cbits, cfg, keys, dyn)
    decays = int((carry.decay_counts - adv.decay_counts).sum()) / len(step_keys)
    words = bits[0].shape[-1]
    db = bound(C14_B * 20 + decays * (40 + 16 * words),
               int_ops=THREEFRY_INT_OPS * (C14_B + 3 * decays))
    emit({"phase": "decay_kernel_times", "B": C14_B, "P": cfg.max_particles,
          "C": cfg.max_chain_log, "launches_per_frame": 10, "kernel_ms": kernel_ms,
          "kernel_ms_runs": kernel_runs, "plain_ms": plain_ms, "plain_ms_runs": plain_runs,
          "decays_per_call": decays, "bound": db, "share": db["bound_ms"] / kernel_ms,
          "card": smi})
    del carry, cbits
    del states, adv, bits, step_keys
    torch.cuda.empty_cache()

    # U-238 down its chain: the alpha path on all eight words.
    # chain_populations' settings below, in _ensemble_setup's order.
    chain_args = (92, 146, U238_CHAIN_B, 30, 3.0, 10, 0, 8, True, 8, None, DEV)
    decay_stats_substep.launches = 0
    t0 = time.perf_counter()
    out = analysis.chain_populations(92, 146, batch=U238_CHAIN_B, frames=30, half_lives=3.0,
                                     device=DEV)
    torch.cuda.synchronize()
    chain_wall = time.perf_counter() - t0
    chain_launches = decay_stats_substep.launches
    assert chain_launches == 300, chain_launches
    # The same run once more through its frame loop, to hold its final state;
    # its populations must be the entry point's.
    _, cfg, final, fn, sim_dt = analysis._ensemble_setup(*chain_args)
    for _ in range(30):
        final, _ = fn(final, sim_dt, 1.0)
    zn, cnt = np.unique(torch.stack([final.z, final.n], 1).cpu().numpy(), axis=0,
                        return_counts=True)
    assert {f"{z}:{n}": int(c) for (z, n), c in zip(zn, cnt)} == {
        k: v[-1] for k, v in out["populations"].items() if v[-1]}
    # Kernel vs plain on its next substep: the members past Pb-214 have
    # filled the 8-slot ring and write over its oldest records.
    chain_check = _main_path_check(final, cfg, sim_dt, "u238_chain_main_path", worst)
    assert chain_check["ring_wrap_decays"] > 0, chain_check
    emit(chain_check)
    counts = final.decay_counts.long()
    alive = final.alive
    n_alive = alive.sum(-1)
    n_prot = (alive & (final.ptype == PROTON)).sum(-1)
    alpha, bm, bp = (counts[:, DECAY_ALPHA], counts[:, DECAY_BETA_MINUS],
                     counts[:, DECAY_BETA_PLUS])
    emit_n, emit_p = counts[:, DECAY_NEUTRON_EMISSION], counts[:, DECAY_PROTON_EMISSION]
    bad_a = int((n_alive != 238 - 4 * alpha - emit_n - emit_p).sum())
    bad_p = int((n_prot != 92 - 2 * alpha - emit_p + bm - bp).sum())
    assert bad_a == 0 and bad_p == 0, (bad_a, bad_p)
    pops = out["populations"]
    assert all(sum(v[t] for v in pops.values()) == U238_CHAIN_B for t in range(31))
    theory = analysis.bateman_populations(92, 146, np.asarray(out["times"]))
    dev_max = max(abs(pops[k][-1] / U238_CHAIN_B - float(v[-1]))
                  for k, v in theory["populations"].items() if k in pops)
    emit({"phase": "stats_slice", "case": "u238_chain_populations", "B": U238_CHAIN_B,
          "frames": 30, "launches": chain_launches, "wall_s": chain_wall,
          "total_alpha": int(alpha.sum()), "members_checked": U238_CHAIN_B,
          "final_populations": {k: v[-1] for k, v in pops.items() if v[-1]},
          "max_abs_dev_from_bateman_final": dev_max, "card": smi})
    return {"name": "decay_stats", "route": "cuda", "source": "pyqmd_tpu_torch/csrc/decay.cu",
            "replaces": "pyqmd_tpu/kernels/decay_pallas.py:78", "launches": launches,
            "max_abs_err": worst[0], "max_rel_err": worst[1], "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": db["bound_ms"], "bound_by": db["bound_by"],
            "library_ms": None}


def phase_stats_cpu_vs_card() -> None:
    for (z, n), b, ts in (((6, 8), 4_096, 1.8e10), ((92, 146), 64, 1.4e16)):
        cfg = SimConfig.for_isotope(z, n, pad_to=8)
        fn = make_decay_frame_fn(cfg, 10)
        cpu = ensemble_init(cfg, b, seed=6, device="cpu")
        card = cpu.to(DEV)
        for _ in range(3):
            cpu, cm = fn(cpu, ts, 1.0)
            card, km = fn(card, ts, 1.0)
        a, c = state_to_numpy(cpu), state_to_numpy(card)
        for f in INT_FIELDS:
            diff = np.flatnonzero((c[f] != a[f]).reshape(b, -1).any(-1))
            assert diff.size == 0, f"{f} differs for members {diff[:10].tolist()}"
        rel = max(rel_err(c[f], a[f]) for f in STATS_FLOATS)
        assert rel <= STATS_REL_TOL, rel
        emit({"phase": "stats_cpu_vs_card", "isotope": f"Z{z}N{n}", "B": b, "frames": 3,
              "decays": int(km["total_decay_counts"].sum()), "max_rel_diff": rel})


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
    worst = phase_decay_kernel()
    kernels.append(phase_stats_slice(smi, worst))
    phase_stats_cpu_vs_card()
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
