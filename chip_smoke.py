#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing JSON or plain lines; any failure raises and exits
nonzero, and nothing catches it:

1. device and build: the card's name and power limit, and the nvcc build
   of ``pyqmd_tpu_torch/csrc`` with its time and ptxas report;
2. the force kernels against their plain PyTorch version, one step: the
   tiled kernel on U-238 (P=256), unaligned P=100 and P=33, a dense cluster
   and P=2000, the sub-warp kernel on P = 2, 5, 8 (He-4), 16, 20 and 32
   (the capacity alone picks it), Euler and leapfrog, exact (rtol = atol =
   1e-4) and fast-math (atol 5e-3), and two launches on the same input
   bitwise equal;
3. the overlap kernel against its plain version on the same sizes plus
   coincident pairs (1e-4), two launches bitwise equal;
4. the full-physics slices: a U-238 ensemble of 10240 nuclei (the tiled
   force kernel) and a He-4 one of 10240 (the sub-warp kernel, no decay),
   3 frames of 20 substeps each at 1e9 years per second, with launch
   counts, decays and NaNs checked, and the rate in nucleus-substeps/s;
   then each kernel's and plain version's time per call at the slices'
   shapes (the U-238 plain versions on a sub-batch of 1024 nuclei), and
   the sub-warp kernel at He-4 B=1,048,576, each beside its bound (below)
   and its launches per frame;
5. the same seed on the CPU (plain versions) and on the card (kernels),
   one frame of U-238 and of He-4: integer fields and RNG streams bitwise,
   pos/vel within 1e-3;
6. the decay-statistics kernel's one-substep form against its plain
   PyTorch version on the card, one substep each of C-14 (B=65536),
   Pb-214 (B=4099), U-238 at P=240 (B=1024) and a U-238 + C-14 mixture,
   then 25 chained Pb-214 substeps: integer fields and bitfield words
   bitwise, half-lives and times within 1e-6 relative;
7. the statistics slice at full width: ``analysis.survival_curve`` of C-14
   at 2,097,152 nuclei (20 frames of 10 substeps; fit within 1% of 5,730
   years, one frame-kernel launch per frame) and
   ``analysis.chain_populations`` of U-238 at 65,536 nuclei (30 launches;
   every member's alive and ptype agree with its decay counts; the
   populations beside the Bateman curve). At both sizes, with the 8-slot
   chain ring the path runs, the frame kernel is held to the plain frame
   (key tree, then a plain substep each) on the path's next frame, next
   rng included (for U-238 with members whose ring wraps), and at the C-14
   size both are timed per frame, beside ten launches of the one-substep
   form;
8. the same seed through the statistics frame on the CPU and on the card,
   C-14 B=4096 and U-238 B=64: integer fields and RNG streams bitwise,
   floats within 1e-6 relative;
9. the host loop on an ensemble at full width: ``Simulation`` of 10240
   U-238 nuclei, then of 10240 He-4 nuclei, at the ``billion`` preset: a
   warm-up frame and 8 ``frame()`` calls (frames retire from the 4-deep
   queue), launch counts per frame, ``status()`` against sums over the
   state, the NaN guard quiet, then the same frames by
   ``run(9, fused=True)`` on a second Simulation of the same seed, every field
   bitwise equal; nucleus-substeps/s of both forms, with the bare
   ``make_frame_fn`` loop timed before and after them; and, with
   PyTorch's synchronisation check raising, three frames, a fused run and
   two rasterized frames that make no synchronising call, and a
   ``status()`` that makes one;
10. Simulation on one U-238 nucleus, CPU against card: 40 frames at
    ``billion`` and one forced decay; integer fields, rng and the decay
    log equal, pos/vel within 1e-3 or the first frame that leaves it;
    the single-nucleus frame time;
11. the command line in process (``cli.main``): an ensemble run with
    ``--save --render --status-json``, ``--load`` of that file, a lone
    U-238 to an animated GIF with panels, ``--survival`` of C-14 at
    2,097,152 (fit within 1%), ``--populations`` with ``--theory`` for
    U-238 at 65,536, ``--list-isotopes``; the files parse;
12. the rasterizer, CPU against card, on an evolved U-238 state with live
    ejecta at 800x600 (zoom 15) and 160x120: differing pixels (at most
    0.1% of the frame) and the card's time per frame, at the host's launch
    pace and for one frame queued behind a spin kernel.

A kernel's bound is the least time the card could take for the same work,
from this run's inputs: the larger of the bytes it must move (each input
read once, each output written once) over 3.35 TB/s and its operations
over their peak (f32 67 TFLOP/s; the special-function unit 16 per SM per
clock x 132 SMs x 1.98 GHz; int32 128 per SM per clock over the integer
and FMA pipes, 3.35e13/s, with the integer pipe's 64 alone beside it). The
force law counts 40 flops and 3 transcendentals per pair (the JAX
package's cost model, ``forces_pallas.py:474, 485``); a threefry2x32 hash
80 int32 operations.

Every phase prints its seconds. The line before the last is the kernels'
JSON summary (``launches`` from phases 4 and 7, ``sim_launches`` from
phase 9); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits nonzero
and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import logging
import math
import struct
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from pyqmd_tpu_torch import (
    SimConfig,
    Simulation,
    analysis,
    cli,
    ensemble_init,
    load_checkpoint,
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
from pyqmd_tpu_torch.kernels.decay import DECAY_FIELDS, decay_stats_frame, decay_stats_substep
from pyqmd_tpu_torch.kernels.forces import SMALL_MAX_PARTICLES, force_step
from pyqmd_tpu_torch.kernels.overlap import overlap_step
from pyqmd_tpu_torch.render import render_frame, render_to_host
from pyqmd_tpu_torch.state import DECAY_ALPHA, DECAY_BETA_MINUS, DECAY_BETA_PLUS, PROTON
from pyqmd_tpu_torch.state import DECAY_NEUTRON_EMISSION, DECAY_PROTON_EMISSION
from pyqmd_tpu_torch.state import state_to_numpy

DEV = torch.device("cuda:0")
DT = 1 / 240.0
EXACT_TOL = 1e-4  # tests/test_kernel.py:43
FAST_ATOL = 5e-3  # tests/test_kernel.py:165
SLICE_B = 10240
HE4_BIG_B = 1_048_576
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
SIM_FRAMES = 8  # after the warm-up frame: enough to retire frames from the 4-deep queue
PIXEL_DIFF_LIMIT = 1e-3  # share of a frame's pixels the card may draw unlike the CPU

# Published H100 SXM peaks (NVIDIA's data sheet and Hopper white paper).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SFU_OPS = 16 * 132 * 1.98e9
# Integer work issues on two pipes: 64 lanes per SM per clock in the
# integer ALU (IADD3, LOP3, SHF) and 64 in the FMA pipe as IMAD, which nvcc
# uses for adds and shifts (a third of the decay frame kernel's integer
# instructions). The ALU's 64 alone is no bound: the frame kernel ran at
# 105% of it.
INT32_OPS = 128 * 132 * 1.98e9
INT32_ALU_OPS = 64 * 132 * 1.98e9
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
    # The sub-warp kernel's capacities; B * next_pow2(P) is not a multiple
    # of 32 for P = 2, 5 and 16, so the grid's last warp holds lanes past
    # the batch, and member 1 of each batch has no alive slot.
    small = SimConfig.for_isotope(2, 2, pad_to=8)
    cases += [
        ("p2", small, 2, 1501, 3.0, 0.9),
        ("p5", small, 5, 777, 10.0, 0.8),
        ("p16", small, 16, 517, 20.0, 0.85),
        ("p20", small, 20, 333, 25.0, 0.85),
        ("p32", small, 32, 257, 30.0, 0.9),
    ]
    for name, base, p, b, spread, frac in cases:
        pos, vel, ptype, alive, _ = random_batch(p, b, seed=p + b, spread=spread, alive_frac=frac)
        if p <= SMALL_MAX_PARTICLES and name != "he4":
            alive[1] = False
        for integrator in ("euler", "leapfrog"):
            exact = dataclasses.replace(base, integrator=integrator, fast_math=False)
            fast = dataclasses.replace(exact, fast_math=True)
            ref_p, ref_v = plain_forces.force_step(pos, vel, ptype, alive, DT, exact)
            small_before = force_step.small_launches
            kp, kv = force_step(pos, vel, ptype, alive, DT, exact)
            fp, fv = force_step(pos, vel, ptype, alive, DT, fast)
            routed_small = force_step.small_launches - small_before
            assert routed_small == (2 if p <= SMALL_MAX_PARTICLES else 0), (name, routed_small)
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
                  "kernel": "sub_warp" if routed_small else "tiled",
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
        ("p5", SimConfig.for_isotope(2, 2, pad_to=8), 5, 777, 4.0, 0.8),
        ("p20", SimConfig.for_isotope(2, 2, pad_to=8), 20, 333, 6.0, 0.85),
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

    force_step.launches = force_step.small_launches = 0
    overlap_step.launches = 0
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        states, metrics = fn(states, TIME_SCALE, FRAME_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"force_step": force_step.launches, "overlap_step": overlap_step.launches,
                "force_step_small": force_step.small_launches}

    assert launches["force_step"] == FRAMES * steps, launches
    assert launches["force_step_small"] == 0, launches
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

    emit({"phase": "kernel_times", "card": smi, "B": SLICE_B, "sub_batch": SUB_B,
          "force": {"launches_per_frame": steps, "ms_full_B": k_force_full,
                    "bound_full_B": fb_full, "share_full_B": share(fb_full, k_force_full),
                    "ms_sub_B": k_force, "plain_ms_sub_B": p_force, "bound_sub_B": fb_sub,
                    "alive_pairs_full_B": alive_pairs(alive)},
          "overlap": {"launches_per_frame": cfg.overlap_iterations, "ms_full_B": k_ov_full,
                      "bound_full_B": ob_full, "share_full_B": share(ob_full, k_ov_full),
                      "ms_sub_B": k_ov, "plain_ms_sub_B": p_ov, "bound_sub_B": ob_sub,
                      "pairs_in_range_full_B": in_range}})
    return [
        {"name": "force", "route": "cuda", "source": "pyqmd_tpu_torch/csrc/forces.cu",
         "replaces": "pyqmd_tpu/kernels/forces_pallas.py:236",
         "launches": launches["force_step"] - launches["force_step_small"],
         "launches_per_frame": steps, "max_abs_err": force_err, "ms": k_force,
         "plain_ms": p_force, "bound_ms": fb_sub["bound_ms"], "bound_by": fb_sub["bound_by"],
         "share": share(fb_sub, k_force), "library_ms": None, "B": SUB_B,
         "ms_full_B": k_force_full, "bound_ms_full_B": fb_full["bound_ms"]},
        {"name": "overlap", "route": "cuda", "source": "pyqmd_tpu_torch/csrc/overlap.cu",
         "replaces": "pyqmd_tpu/kernels/overlap_pallas.py:38",
         "launches": launches["overlap_step"], "launches_per_frame": cfg.overlap_iterations,
         "max_abs_err": ov_err, "ms": k_ov, "plain_ms": p_ov, "bound_ms": ob_sub["bound_ms"],
         "bound_by": ob_sub["bound_by"], "share": share(ob_sub, k_ov), "library_ms": None,
         "B": SUB_B, "ms_full_B": k_ov_full, "bound_ms_full_B": ob_full["bound_ms"]},
    ]


def share(b: dict, ms: float) -> float:
    return b["bound_ms"] / ms


def phase_he4_slice(smi: str) -> dict:
    """The He-4 full-physics frame (P=8, the sub-warp force kernel) at the
    slice's batch, then the kernel per call at that batch and at
    HE4_BIG_B, beside its bound and the plain version."""
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    steps = 20
    states = ensemble_init(cfg, SLICE_B, seed=0, device=DEV)
    fn = make_frame_fn(cfg, steps, batched=True)
    states, _ = fn(states, TIME_SCALE, FRAME_DT)  # warm-up frame
    torch.cuda.synchronize()

    force_step.launches = force_step.small_launches = 0
    overlap_step.launches = 0
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        states, metrics = fn(states, TIME_SCALE, FRAME_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"force_step": force_step.launches, "force_step_small": force_step.small_launches,
                "overlap_step": overlap_step.launches}
    assert launches["force_step_small"] == launches["force_step"] == FRAMES * steps, launches
    assert launches["overlap_step"] == FRAMES * cfg.overlap_iterations, launches
    assert not bool(metrics["nan"].any()), "NaN in the He-4 ensemble"
    assert int(metrics["total_decay_counts"].sum()) == 0, "a stable nucleus decayed"
    assert bool(torch.isfinite(states.pos).all()) and states.pos.shape == (SLICE_B, 8, 2)
    emit({"phase": "slice", "isotope": "He-4", "B": SLICE_B, "P": cfg.max_particles,
          "frames": FRAMES, "substeps_per_frame": steps, "wall_s": wall,
          "nucleus_substeps_per_s": SLICE_B * steps * FRAMES / wall, "launches": launches,
          "total_alive": int(metrics["total_alive"]), "card": smi})

    pos, vel, ptype, alive = states.pos, states.vel, states.ptype, states.alive
    k_ms = device_ms(lambda: force_step(pos, vel, ptype, alive, DT, cfg), DEV, 50)
    p_ms = device_ms(lambda: plain_forces.force_step(pos, vel, ptype, alive, DT, cfg), DEV, 5)
    err = max(max_diff(a, b) for a, b in zip(force_step(pos, vel, ptype, alive, DT, cfg),
                                             plain_forces.force_step(pos, vel, ptype, alive,
                                                                     DT, cfg)))
    assert err <= FAST_ATOL, err  # cfg runs fast_math, as the slice does
    fb = force_bound(alive)

    big = ensemble_init(cfg, HE4_BIG_B, seed=1, device=DEV)
    bp, bv, bt, ba = big.pos, big.vel, big.ptype, big.alive
    k_big = device_ms(lambda: force_step(bp, bv, bt, ba, DT, cfg), DEV, 20)
    big_err = max(max_diff(a, b) for a, b in zip(force_step(bp, bv, bt, ba, DT, cfg),
                                                 plain_forces.force_step(bp, bv, bt, ba, DT,
                                                                         cfg)))
    assert big_err <= FAST_ATOL, big_err
    fb_big = force_bound(ba)
    emit({"phase": "kernel_times", "kernel": "force_small", "card": smi, "P": 8,
          "launches_per_frame": steps, "B": SLICE_B, "ms": k_ms, "plain_ms": p_ms, "bound": fb,
          "share": share(fb, k_ms), "max_abs_err": err, "B_big": HE4_BIG_B, "ms_big": k_big,
          "bound_big": fb_big, "share_big": share(fb_big, k_big), "max_abs_err_big": big_err})
    return {"name": "force_small", "route": "cuda",
            "source": "pyqmd_tpu_torch/csrc/forces_small.cu",
            "replaces": "pyqmd_tpu/kernels/forces_pallas.py:117",
            "launches": launches["force_step_small"], "launches_per_frame": steps,
            "max_abs_err": max(err, big_err), "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"], "share": share(fb, k_ms),
            "library_ms": None, "B": SLICE_B, "ms_big_B": k_big,
            "bound_ms_big_B": fb_big["bound_ms"], "big_B": HE4_BIG_B}


def phase_cpu_vs_card() -> None:
    # He-4 at B=1001: 8008 lanes, so the sub-warp kernel's last warp is ragged.
    for (z, n), b in (((92, 146), 8), ((2, 2), 64), ((2, 2), 1001)):
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
        small_before = force_step.small_launches
        card, km = fn(cpu0.to(DEV), ts, FRAME_DT)
        small = force_step.small_launches - small_before
        assert small == (steps if cfg.max_particles <= SMALL_MAX_PARTICLES else 0), small
        a, c = state_to_numpy(cpu), state_to_numpy(card)
        for f in INT_FIELDS:
            np.testing.assert_array_equal(c[f], a[f], err_msg=f)
        np.testing.assert_allclose(c["pos"], a["pos"], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(c["vel"], a["vel"], rtol=1e-3, atol=1e-3)
        emit({"phase": "cpu_vs_card", "isotope": f"Z{z}N{n}", "B": b, "substeps": steps,
              "force_kernel": "sub_warp" if small else "tiled",
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


def _next_frame_inputs(states, cfg, sim_dt):
    """The state, packed nucleons and dynamics that the statistics frame
    hands its next frame-kernel launch (10 substeps)."""
    adv, dyn = step._frame_clock(states, cfg, sim_dt, 1.0, 10, cfg.effective_dt(),
                                 cfg.physics_dt)
    return adv, plain_decay.pack_nucleon_bits(adv.alive, adv.ptype), dyn


def _plain_frame(adv, bits, cfg, dyn, substeps: int):
    """The frame kernel's plain version: the frame's key tree, then one
    plain substep per key. Returns the carry, bitfields and next rng."""
    k3 = prng.split(adv.rng, 3)
    st = adv
    for keys in prng.split(k3[:, 0], substeps).transpose(0, 1):
        st, _, bits = plain_decay.maybe_decay(st, cfg, keys.contiguous(), dyn, stats_only=True,
                                              packed_nucleons=bits)
    return st, bits, k3[:, 2]


def _main_path_check(states, cfg, sim_dt, what, worst) -> dict:
    """Frame kernel vs plain frame on the main path's own next frame: its
    batch, its chain ring, its rng and clock. Raises on a difference;
    returns what was compared, the decays that wrote past the ring's end
    and the members that decayed more than once."""
    adv, bits, dyn = _next_frame_inputs(states, cfg, sim_dt)
    want, want_bits, want_rng = _plain_frame(adv, bits, cfg, dyn, 10)
    got, got_bits = _clone_carry(adv, bits)
    next_rng = decay_stats_frame(got, got_bits, adv.rng, cfg, dyn, 10)
    torch.cuda.synchronize()
    assert torch.equal(next_rng, want_rng), f"{what}: next rng differs"
    abs_d, rel = _compare_stats(want, want_bits, got, got_bits, what)
    worst[0], worst[1] = max(worst[0], abs_d), max(worst[1], rel)
    fired = got.chain_cursor - adv.chain_cursor
    wrapped = int(((fired > 0) & (got.chain_cursor > cfg.max_chain_log)).sum())
    return {"phase": "decay_frame_kernel", "case": what, "B": adv.batch,
            "P": cfg.max_particles, "C": cfg.max_chain_log, "substeps": 10,
            "decays": int(fired.sum()), "members_decayed_twice": int((fired > 1).sum()),
            "ring_wrap_members": wrapped, "next_rng_bitwise": True,
            "max_abs_diff": abs_d, "max_rel_diff": rel}


def frame_ms(adv, bits, cfg, dyn, form: str, reps: int) -> list[float]:
    """Device time of one statistics frame's decay pass (10 substeps),
    each rep on a fresh copy of the carry, so every rep sees the frame's
    real decays: ``form`` "frame" is one frame-kernel launch, "substeps"
    the key tree and ten launches of the one-substep form, "plain" the
    plain frame. The card is held busy while the calls are queued, so host
    gaps between launches are not timed."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for r in range(reps + 1):  # rep 0 warms up
        carry, cbits = _clone_carry(adv, bits)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        if form == "frame":
            decay_stats_frame(carry, cbits, adv.rng, cfg, dyn, 10)
        elif form == "substeps":
            k3 = prng.split(adv.rng, 3)
            for keys in prng.split(k3[:, 0], 10).transpose(0, 1).contiguous():
                decay_stats_substep(carry, cbits, cfg, keys, dyn)
        else:
            _plain_frame(carry, cbits, cfg, dyn, 10)
        end.record()
        torch.cuda.synchronize()
        if r:
            out.append(start.elapsed_time(end))
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
    decay_stats_frame.launches = decay_stats_substep.launches = 0
    t0 = time.perf_counter()
    res = analysis.survival_curve(6, 8, batch=C14_B, frames=20, half_lives=2.0, substeps=10,
                                  seed=0, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = decay_stats_frame.launches
    assert launches == 20 and decay_stats_substep.launches == 0, (
        launches, decay_stats_substep.launches)
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

    # Frame kernel vs plain frame at the main path's size (B=2M, the 8-slot
    # chain ring), on the inputs of the frame's next frame (after 11 frames).
    worst = list(worst)
    c14_check = _main_path_check(states, cfg, sim_dt, "c14_main_path", worst)
    assert c14_check["decays"] > C14_B // 200, c14_check
    emit(c14_check)

    # Per frame, each rep from a fresh carry: the frame kernel, the key tree
    # with ten launches of the one-substep form, and the plain frame.
    adv, bits, dyn = _next_frame_inputs(states, cfg, sim_dt)
    kernel_runs = frame_ms(adv, bits, cfg, dyn, "frame", reps=10)
    substep_runs = frame_ms(adv, bits, cfg, dyn, "substeps", reps=5)
    plain_runs = frame_ms(adv, bits, cfg, dyn, "plain", reps=3)
    kernel_ms, plain_ms = float(np.mean(kernel_runs)), float(np.mean(plain_runs))
    # Bound over the same frame: every nucleus reads its rng and half-life
    # and writes its next rng (36 bytes) and hashes 2 + 2 x 10 threefry
    # blocks (two frame splits, a key split and a Bernoulli uniform per
    # substep); a decay adds ~40 + 16 W bytes (decay.cu) and three hashes.
    carry, cbits = _clone_carry(adv, bits)
    decay_stats_frame(carry, cbits, adv.rng, cfg, dyn, 10)
    decays = int((carry.decay_counts - adv.decay_counts).sum())
    words = bits[0].shape[-1]
    db = bound(C14_B * 36 + decays * (40 + 16 * words),
               int_ops=THREEFRY_INT_OPS * (C14_B * (2 + 2 * 10) + 3 * decays))
    emit({"phase": "decay_kernel_times", "B": C14_B, "P": cfg.max_particles,
          "C": cfg.max_chain_log, "substeps": 10, "launches_per_frame": 1,
          "frame_kernel_ms": kernel_ms, "frame_kernel_ms_runs": kernel_runs,
          "substep_form_key_tree_and_x10_ms_runs": substep_runs,
          "plain_frame_ms": plain_ms, "plain_frame_ms_runs": plain_runs,
          "decays_per_frame": decays, "bound": db, "share": db["bound_ms"] / kernel_ms,
          "int32_alu_pipe_only_ms": db["bound_parts_ms"]["int32"] * INT32_OPS / INT32_ALU_OPS,
          "card": smi})
    del carry, cbits
    del states, adv, bits
    torch.cuda.empty_cache()

    # U-238 down its chain: the alpha path on all eight words.
    # chain_populations' settings below, in _ensemble_setup's order.
    chain_args = (92, 146, U238_CHAIN_B, 30, 3.0, 10, 0, 8, True, 8, None, DEV)
    decay_stats_frame.launches = decay_stats_substep.launches = 0
    t0 = time.perf_counter()
    out = analysis.chain_populations(92, 146, batch=U238_CHAIN_B, frames=30, half_lives=3.0,
                                     device=DEV)
    torch.cuda.synchronize()
    chain_wall = time.perf_counter() - t0
    chain_launches = decay_stats_frame.launches
    assert chain_launches == 30 and decay_stats_substep.launches == 0, chain_launches
    # The same run once more through its frame loop, to hold its final state;
    # its populations must be the entry point's.
    _, cfg, final, fn, sim_dt = analysis._ensemble_setup(*chain_args)
    for _ in range(30):
        final, _ = fn(final, sim_dt, 1.0)
    zn, cnt = np.unique(torch.stack([final.z, final.n], 1).cpu().numpy(), axis=0,
                        return_counts=True)
    assert {f"{z}:{n}": int(c) for (z, n), c in zip(zn, cnt)} == {
        k: v[-1] for k, v in out["populations"].items() if v[-1]}
    # Frame kernel vs plain frame on its next frame: the members past Pb-214
    # have filled the 8-slot ring and write over its oldest records.
    chain_check = _main_path_check(final, cfg, sim_dt, "u238_chain_main_path", worst)
    assert chain_check["ring_wrap_members"] > 0, chain_check
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
            "launches_per_frame": 1, "max_abs_err": worst[0], "max_rel_err": worst[1],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": db["bound_ms"],
            "bound_by": db["bound_by"], "share": db["bound_ms"] / kernel_ms,
            "library_ms": None, "B": C14_B, "per": "frame of 10 substeps"}


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


class _ErrorLog(logging.Handler):
    """Collects the simulation's ERROR records (the NaN guard logs there)."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_sim_ensemble(smi: str, z: int, n: int, pad_to: int) -> dict:
    """``Simulation`` on 10240 nuclei: frames in flight, then a fused run
    of the same frames on a second one; returns the kernels' launches
    of the frame loop."""
    errors = _ErrorLog()
    logging.getLogger("pyqmd_tpu_torch").addHandler(errors)
    sim = Simulation(z=z, n=n, ensemble=SLICE_B, pad_to=pad_to, seed=0, device=DEV)
    sim.set_preset("billion")
    sim.nan_check_interval = 3  # the guard reads its flag three times in this run
    sim.frame()  # warm-up frame
    torch.cuda.synchronize()
    small = sim.cfg.max_particles <= SMALL_MAX_PARTICLES

    # The bare frame loop on an ensemble of its own, before the Simulation's
    # frames and again after the fused run, so all three are timed in turns.
    bare_fn = make_frame_fn(sim.cfg, 20, batched=True)
    bare = ensemble_init(sim.cfg, SLICE_B, seed=1, device=DEV)

    def bare_ms_per_frame() -> float:
        nonlocal bare
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SIM_FRAMES):
            bare, _ = bare_fn(bare, TIME_SCALE, FRAME_DT)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / SIM_FRAMES * 1e3

    bare_ms = [bare_ms_per_frame()]

    force_step.launches = force_step.small_launches = 0
    overlap_step.launches = 0
    per_frame = []
    t0 = time.perf_counter()
    for _ in range(SIM_FRAMES):
        before = (force_step.launches, overlap_step.launches)
        sim.frame()
        per_frame.append((force_step.launches - before[0], overlap_step.launches - before[1]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"force_step": force_step.launches, "force_step_small": force_step.small_launches,
                "overlap_step": overlap_step.launches}
    steps = sim.substeps_used
    assert steps == 20, steps
    assert per_frame == [(steps, 1)] * SIM_FRAMES, per_frame
    assert launches["force_step_small"] == (launches["force_step"] if small else 0), launches
    assert len(sim._inflight) == 3 and all(f.event.query() for f in sim._inflight)

    status = sim.status()
    st = sim.state
    assert status["alive"] == int(st.alive.sum()), status
    assert status["decay_counts"] == st.decay_counts.sum(0).tolist(), status
    assert status["ensemble"] == SLICE_B and status["substeps"] == steps
    assert status["fps"] > 0 and status["substeps_per_sec"] > 0, status
    assert not errors.messages, errors.messages
    assert bool(torch.isfinite(st.pos).all()) and st.pos.shape == (SLICE_B, sim.cfg.max_particles, 2)
    if z > 2:
        assert sum(status["decay_counts"]) > 0, "no decay fired"
    else:
        assert sum(status["decay_counts"]) == 0, "a stable nucleus decayed"

    # Nothing on the frame path waits for the card: with PyTorch's
    # synchronisation check set to raise, three frames (fewer than the queue
    # holds, so none is fenced), a fused run and two rasterized frames go
    # through; status() then makes one synchronising call, its packed readback.
    probe = Simulation(z=z, n=n, ensemble=SLICE_B, pad_to=pad_to, seed=2, device=DEV)
    probe.set_preset("billion")
    probe.nan_check_interval = 0
    # The first picture on a device copies the colour and label tables there.
    render_frame(probe.state, (400.0, 400.0), 15.0, 160, 120)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            probe.frame()
        probe.run(2, fused=True)
        render_frame(probe.state, (400.0, 400.0), 15.0, 160, 120, index=3)
        probe.render_fit_device(160, 120, index=3)
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            probe.status()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    status_syncs = sum("synchroniz" in str(w.message) for w in caught)
    assert status_syncs == 1, [str(w.message) for w in caught]
    del probe

    fused = Simulation(z=z, n=n, ensemble=SLICE_B, pad_to=pad_to, seed=0, device=DEV)
    fused.set_preset("billion")
    force_step.launches = force_step.small_launches = 0
    overlap_step.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = fused.run(SIM_FRAMES + 1, fused=True)
    torch.cuda.synchronize()
    fused_wall = time.perf_counter() - t0
    assert force_step.launches == (SIM_FRAMES + 1) * steps, force_step.launches
    assert overlap_step.launches == SIM_FRAMES + 1, overlap_step.launches
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(fused.state, f.name), getattr(st, f.name)), (
            f"fused run differs from the frame loop in {f.name}")
    assert int(metrics["total_alive"]) == status["alive"]
    assert fused.frame_count == sim.frame_count == SIM_FRAMES + 1
    logging.getLogger("pyqmd_tpu_torch").removeHandler(errors)
    bare_ms.append(bare_ms_per_frame())
    emit({"phase": "sim_ensemble", "isotope": sim.isotope, "B": SLICE_B,
          "P": sim.cfg.max_particles, "frames": SIM_FRAMES, "substeps_per_frame": steps,
          "launches": launches, "bare_make_frame_fn_ms_per_frame_before_and_after": bare_ms,
          "frame_loop_wall_s": wall,
          "frame_loop_ms_per_frame": wall / SIM_FRAMES * 1e3,
          "frame_loop_nucleus_substeps_per_s": SLICE_B * steps * SIM_FRAMES / wall,
          "fused_frames": SIM_FRAMES + 1, "fused_wall_s": fused_wall,
          "fused_ms_per_frame": fused_wall / (SIM_FRAMES + 1) * 1e3,
          "fused_nucleus_substeps_per_s": SLICE_B * steps * (SIM_FRAMES + 1) / fused_wall,
          "fused_bitwise_equal": True, "status_fps": status["fps"],
          "status_substeps_per_sec": status["substeps_per_sec"],
          "status_alive": status["alive"], "status_decay_counts": status["decay_counts"],
          "nan_guard_checks": sim.frame_count // sim.nan_check_interval,
          "synchronising_calls_in_3_frames_a_fused_run_and_2_renders": 0,
          "synchronising_calls_in_status": status_syncs, "card": smi})
    return launches


def phase_sim_single(smi: str) -> None:
    """One U-238 nucleus through ``Simulation`` on the CPU and on the card,
    frame by frame."""
    frames = 40
    cpu = Simulation(z=92, n=146, seed=0, pad_to=128, device="cpu")
    card = Simulation(z=92, n=146, seed=0, pad_to=128, device=DEV)
    first_out, worst_in = None, 0.0
    force_step.launches = 0
    for s in (cpu, card):
        s.set_preset("billion")
    for f in range(frames):
        cpu.frame()
        card.frame()
        d = max(float((card.state.pos.cpu() - cpu.state.pos).abs().max()),
                float((card.state.vel.cpu() - cpu.state.vel).abs().max()))
        if first_out is None:
            if d <= 1e-3:
                worst_in = max(worst_in, d)
            else:
                first_out = f + 1
    assert first_out is None or first_out > 1, "the first frame already differs"
    assert force_step.launches == frames * 20, force_step.launches
    for s in (cpu, card):
        s.force_decay()
    a, c = state_to_numpy(cpu.state), state_to_numpy(card.state)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(c[f], a[f], err_msg=f)
    decay_log = card.decay_log
    assert decay_log == cpu.decay_log and len(decay_log) >= 1, decay_log
    sc, sk = cpu.status(), card.status()
    for k in ("isotope", "z", "n", "alive", "ejecta", "decay_counts", "time_passed", "substeps"):
        assert sk[k] == sc[k], (k, sk[k], sc[k])
    assert sk["backend"] == "cuda" and sc["backend"] == "cpu"

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        card.frame()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 100.0
    emit({"phase": "sim_single", "isotope": "U-238", "frames": frames,
          "int_fields_rng_and_log_equal": True, "decay_log": decay_log,
          "pos_vel_within_1e-3_frames": frames if first_out is None else first_out - 1,
          "first_frame_outside_1e-3": first_out, "max_abs_diff_while_within": worst_in,
          "card_ms_per_frame": frame_ms, "card_fps_status": card.status()["fps"], "card": smi})


def _png_size(path: Path) -> tuple[int, int]:
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR", path
    return struct.unpack(">II", data[16:24])


def _gif_frames(data: bytes) -> tuple[tuple[int, int], int]:
    """Walk a GIF's blocks; returns its (width, height) and image count."""
    assert data[:6] == b"GIF89a", "not a GIF"
    size = struct.unpack("<HH", data[6:10])
    i = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 0x80 else 0)

    def skip_sub_blocks(i: int) -> int:
        while data[i]:
            i += 1 + data[i]
        return i + 1

    images = 0
    while data[i] != 0x3B:
        if data[i] == 0x21:  # extension: label, then sub-blocks
            i = skip_sub_blocks(i + 2)
        else:
            assert data[i] == 0x2C, f"unknown GIF block {data[i]:#x} at {i}"
            flags = data[i + 9]
            i += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
            i = skip_sub_blocks(i + 1)  # LZW minimum code size, then the data
            images += 1
    assert i == len(data) - 1, "bytes after the GIF trailer"
    return size, images


def _cli(args: list) -> str:
    """``cli.main(args)`` with its standard output captured; it must return 0."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(args)
    assert rc == 0, (args, rc)
    return out.getvalue()


def phase_cli(smi: str) -> None:
    """The command line's modes in process, on the card (its default)."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ck, png, gif = tmp / "run.npz", tmp / "out.png", tmp / "chain.gif"
        t0 = time.perf_counter()
        out = _cli(["--isotope", "U-238", "--ensemble", str(SLICE_B), "--frames", "10",
                    "--time-scale", "1e9yr", "--render", str(png), "--save", str(ck),
                    "--status-json", "-q"])
        run_s = time.perf_counter() - t0
        status = json.loads(out.strip().splitlines()[-1])
        assert status["ensemble"] == SLICE_B and status["isotope"] == f"U-238 x{SLICE_B}", status
        assert status["substeps"] == 20 and status["fps"] > 0, status
        assert _png_size(png) == (480, 480)  # the 4x4 montage of 120-pixel tiles
        state, cfg = load_checkpoint(str(ck))
        assert state.batch == SLICE_B and state.pos.is_cuda and cfg.max_particles == 256
        assert int(state.alive.sum()) == status["alive"]

        out = _cli(["--load", str(ck), "--frames", "2", "--time-scale", "1e9yr", "--status-json",
                    "-q"])
        resumed = json.loads(out.strip().splitlines()[-1])
        assert resumed["ensemble"] == SLICE_B and resumed["alive"] <= status["alive"], resumed

        t0 = time.perf_counter()
        _cli(["--isotope", "U-238", "--frames", "20", "--time-scale", "1e11yr", "--render",
              str(gif), "--render-every", "5", "-q"])
        gif_s = time.perf_counter() - t0
        data = gif.read_bytes()
        assert _gif_frames(data) == ((800, 600), 4), _gif_frames(data)
        still = tmp / "still.png"
        _cli(["--isotope", "U-238", "--frames", "3", "--render", str(still), "-q"])
        assert _png_size(still) == (800, 600)

        csv = tmp / "c14.csv"
        t0 = time.perf_counter()
        out = _cli(["--isotope", "C-14", "--ensemble", str(C14_B), "--survival", str(csv), "-q"])
        survival_s = time.perf_counter() - t0
        fit = json.loads(out.strip().splitlines()[-1])
        assert fit["rel_error"] < 0.01, fit
        rows = csv.read_text().strip().splitlines()
        assert rows[0] == "time_s,survival,activity_per_s" and len(rows) == 22

        pops, theory = tmp / "pops.csv", tmp / "theory.csv"
        _cli(["--isotope", "U-238", "--ensemble", str(U238_CHAIN_B), "--populations", str(pops),
              "--theory", str(theory), "--frames", "30", "--half-lives", "3", "-q"])
        head = pops.read_text().splitlines()[0].split(",")
        last = dict(zip(head, pops.read_text().strip().splitlines()[-1].split(",")))
        assert sum(int(v) for k, v in last.items() if k != "time_s") == U238_CHAIN_B
        th = theory.read_text().strip().splitlines()
        assert len(th) == 32 and abs(sum(float(x) for x in th[-1].split(",")[1:]) - 1.0) < 1e-6
        assert "U-238" in _cli(["--list-isotopes"])
    emit({"phase": "cli", "ensemble_run_s": run_s, "ensemble_status": status,
          "resumed_alive": resumed["alive"], "gif_run_s": gif_s, "gif_bytes": len(data),
          "survival_run_s": survival_s, "survival_fit": fit,
          "u238_final_populations": {k: int(v) for k, v in last.items()
                                     if k != "time_s" and int(v)}, "card": smi})


def phase_rasterizer(smi: str) -> None:
    """The same evolved state drawn on the card and on the CPU."""
    sim = Simulation(z=92, n=146, seed=0, pad_to=128, device=DEV)
    sim.set_time_scale(3.15576e18)  # 1e11 years per second: the chain runs down
    for _ in range(5):
        sim.frame()
    for _ in range(3):
        sim.force_decay()  # fresh ejecta
    state = sim.state
    live = int(state.ej_alive.sum())
    assert live > 0, "no live ejecta to draw"
    cpu_state = state.to("cpu")
    out = {"phase": "rasterizer", "isotope": sim.isotope, "live_ejecta": live, "card": smi}
    for (w, h), zoom in (((800, 600), 15.0), ((160, 120), 15.0)):
        card = render_to_host(state, (400.0, 400.0), zoom, w, h)
        cpu = render_to_host(cpu_state, (400.0, 400.0), zoom, w, h)
        assert card.shape == (h, w, 3) and (card.sum(-1) > 0).sum() > 50
        diff = int((card != cpu).any(-1).sum())
        assert diff <= PIXEL_DIFF_LIMIT * w * h, (w, h, diff)
        draw = lambda: render_frame(state, (400.0, 400.0), zoom, w, h)  # noqa: E731
        ms = device_ms(draw, DEV, 20)  # 20 frames back to back: the host's launch pace
        alone_ms = device_ms(draw, DEV, 1)  # one frame queued behind the spin: the card's time
        t0 = time.perf_counter()
        for _ in range(5):
            render_to_host(state, (400.0, 400.0), zoom, w, h)
        out[f"{w}x{h}"] = {"differing_pixels": diff, "pixels": w * h,
                           "card_ms_host_paced": ms, "card_ms_device": alone_ms,
                           "card_to_host_wall_ms": (time.perf_counter() - t0) * 200.0,
                           "drawn_pixels": int((card.sum(-1) > 0).sum())}
    fit = sim.render_fit_device(160, 120)
    assert fit.is_cuda and (fit.cpu().numpy() == sim._render_fit(160, 120)).mean() > 0.995
    t0 = time.perf_counter()
    panels = sim.render(800, 600)
    out["render_with_panels_wall_ms"] = (time.perf_counter() - t0) * 1e3
    assert panels.shape == (600, 800, 3)
    emit(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = [time.perf_counter()]

    def timed(name: str, fn, *args):
        out = fn(*args)
        torch.cuda.synchronize()
        now = time.perf_counter()
        emit({"phase_seconds": name, "seconds": round(now - clock[0], 3)})
        clock[0] = now
        return out

    smi = timed("1 device and build", phase_device_and_build)
    timed("2 force kernels", phase_force_kernel)
    timed("3 overlap kernel", phase_overlap_kernel)
    kernels = timed("4 U-238 slice", phase_slice, smi)
    kernels.insert(1, timed("4 He-4 slice", phase_he4_slice, smi))
    timed("5 CPU vs card", phase_cpu_vs_card)
    worst = timed("6 decay kernel", phase_decay_kernel)
    kernels.append(timed("7 statistics slice", phase_stats_slice, smi, worst))
    timed("8 statistics CPU vs card", phase_stats_cpu_vs_card)
    u238 = timed("9 Simulation U-238 ensemble", phase_sim_ensemble, smi, 92, 146, 128)
    he4 = timed("9 Simulation He-4 ensemble", phase_sim_ensemble, smi, 2, 2, 8)
    timed("10 Simulation single nucleus", phase_sim_single, smi)
    decay_stats_frame.launches = 0
    timed("11 command line", phase_cli, smi)
    cli_decay_launches = decay_stats_frame.launches
    timed("12 rasterizer", phase_rasterizer, smi)
    by_name = {k["name"]: k for k in kernels}
    by_name["force"]["sim_launches"] = u238["force_step"]
    by_name["overlap"]["sim_launches"] = u238["overlap_step"] + he4["overlap_step"]
    by_name["force_small"]["sim_launches"] = he4["force_step_small"]
    by_name["decay_stats"]["sim_launches"] = cli_decay_launches  # --survival, --populations
    assert all(k["launches"] > 0 and k["sim_launches"] > 0 for k in kernels), kernels
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
