#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing JSON or plain lines; any failure raises and exits
nonzero, and nothing catches it:

1. device and build: the card's name and power limit, and the nvcc build
   of ``pyqmd_tpu_torch/csrc`` with its time and ptxas report;
2. the force kernels against their plain PyTorch version, one step: the
   tiled kernel on U-238 (P=256), unaligned P=100 and P=33, a dense cluster,
   P=600 (static and dynamic shared memory just past 48 KB) and P=2000, the
   sub-warp kernel on P = 2, 5, 8 (He-4), 16, 20 and 32
   (the capacity alone picks it), Euler and leapfrog, exact (rtol = atol =
   1e-4) and fast-math (atol 5e-3), and two launches on the same input
   bitwise equal;
3. the overlap kernel against its plain version on the same sizes plus
   coincident pairs (1e-4), two launches bitwise equal;
4. the full-physics slices: a U-238 ensemble of 10240 nuclei (the tiled
   force kernel) and a He-4 one of 10240 (the sub-warp kernel, no decay),
   3 frames of 20 substeps each at 1e9 years per second, with launch
   counts (the substep kernel's one a substep among them), decays and NaNs
   checked, and the rate in nucleus-substeps/s;
   then each kernel's and plain version's time per call at the slices'
   shapes (the U-238 force and overlap plain versions on a sub-batch of
   1024 nuclei), and the sub-warp kernel at He-4 B=1,048,576, each beside
   its bound (below) and its launches per frame; the substep kernel on the
   U-238 slice's own state (two substeps against the plain ones on the
   card: integers, clock and decay floats and velocities bitwise, fragment
   positions within 1e-4), its time alone, the frame's clone of what it
   writes, and its mean time inside a replayed frame under the profiler;
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
    pace and for one frame queued behind a spin kernel;
13. packed frames: ``render_frame_packed`` on the card and ``unpack_frame``
    on the host, on phase 12's evolved U-238 state and on a He-4 nucleus
    at 800x600: the flag set, the unpacked frame bitwise ``render_frame``'s,
    the packed array against the CPU port's (at most 0.1% of its bytes),
    ``ValueError`` at width 40; its card time beside ``render_frame``'s;
14. the pipelined frame reader on one U-238 nucleus at ``billion``: 20
    frames of ``frame()`` + draw + ``submit`` at depth 3, with the 64x44
    RGB frame of the ``watch`` loop and with the 800x600 packed frame, the
    draw and the ``submit`` under PyTorch's synchronisation check: None for
    the first 3, 17 frames handed out and 3 flushed, in order, each bitwise
    the blocking readback of its device frame; 4 pinned buffers, allocated
    once; ms per delivered frame beside depth 1 and a blocking
    ``.cpu().numpy()`` per frame; a CPU tensor takes no pinned buffer;
15. the browser viewer on the card: ``LiveViewServer`` on one U-238 nucleus
    (fps 30, 800x600) through ``urllib``: the page, three ``/frame`` PNGs,
    strict-JSON ``/status``, controls (faster, decay, a bad action 400, a
    bad path 404), two ``/stream`` readers at once that see one sequence
    while the simulation advances by the frames made and the force and
    overlap kernels are launched 20 times and once per frame; the server
    closes and its thread ends; a He-4 viewer (the sub-warp kernel) and a
    viewer on 10240 U-238 nuclei (``decay`` answers 400);
16. the live views from the command line, in process: the REPL's ``watch``
    and ``--serve`` with one ``/frame`` fetched; then every script of
    ``examples_torch/`` but ``sharded_survival.py`` (phase 17) on its
    default device (the card), four as subprocesses all at once and
    ``survival_curve.py`` in process, where its
    decay-kernel launches are read; the C-14 fit within 1%, and the orders
    of Euler and leapfrog from the sub-warp force kernel;
17. the sharded path (``pyqmd_tpu_torch.parallel``) in a world of one:
    ``make_mesh()`` starts NCCL rank 0 of 1 on the card, and every line
    says so (``"world": 1, "backend": "nccl"``). ``make_sharded_frame_fn``
    on the U-238 and He-4 slices (10240 nuclei, 20 substeps), a CUDA graph
    replay of the rank's bucket then one ``all_reduce``, over the calls of
    one bucket (the first captures, then a replay at 1e9 years per second,
    at 1e7 and at a frame interval of 1/30 s, each with PyTorch's
    synchronisation check raising): every field and metric bitwise the
    eager sharded form (``sharded_frame`` around ``ensemble_step``) and
    every field bitwise the bare ``make_frame_fn`` graph loop on the same
    seed, one capture, launches equal to eager's, ``survivors`` the count
    of members still in the initial isotope; ms per frame in turns (eager,
    graph, bare graph, graph, eager), capture seconds, pool bytes;
    ``make_sharded_run_fn`` over the same frames, bitwise the frame loop;
    ``make_sharded_decay_fn`` (eager: one launch per frame) on C-14 at
    2,097,152 nuclei, 20 frames of 10 substeps, bitwise the bare decay
    loop, the fit from ``survivors`` within 1% of 5,730 years with 20
    frame-kernel launches; ``save_checkpoint_sharded`` /
    ``load_checkpoint_sharded`` of that state (seconds and bytes), every
    field and the next frame bitwise; the ring (``make_ring_force_step``,
    ``make_ring_frame_fn``, one U-238 nucleus) and the hybrid frame
    (``make_hybrid_frame_fn``, U-238 B=1024, P=256), exact math: a force
    step through the ring within 1e-4 of the kernel's, then each frame
    factory (a graph with the ring's ``all_reduce``s and ``all_gather``
    inside it) over the calls of one bucket, every replay bitwise the eager
    frame (the bare frame with the ring step) in every field and metric,
    the first also bitwise the frame with the plain force step, integer
    fields equal to the kernel frame's and pos/vel within 1e-3 of it
    (phase 5's bar for a frame) after the first, one capture, overlap
    launches only (the ring's hop is tensor code, as in the reference),
    as eager; ms per frame in turns (eager, graph, eager) beside the
    kernel frame's, capture seconds and pool bytes; then
    ``examples_torch/sharded_survival.py`` as a subprocess on its default
    device. The group is destroyed at the end of the phase;
18. the compiled frame buckets (``pyqmd_tpu_torch/core/graphs.py``) on
    fresh factories, for U-238 and He-4 at 10240 nuclei and one U-238
    nucleus: the first call (the eager frame, returned, and the capture),
    then five replays bitwise the eager frames (every field and metric)
    at 1e9 years per second, then 1e7, then a frame interval of 1/30 s,
    with one capture; launch counters equal to eager's; a replay and three
    ``Simulation.frame()`` calls with PyTorch's synchronisation check
    raising; ``make_run_fn(3)`` twice, bitwise three eager frames each;
    then ms per frame in turns (eager, graph, ``frame()``, graph, eager),
    the card's idle share over three profiled graph frames, the capture's
    seconds, the replay and the copies in and out on the card's clock,
    and the bytes of the graphs' shared memory pool.

Phases 4, 9, 10 and 14-17 call the frame factories, so they run on the
graphs too; a bucket's first call captures, which synchronises the card,
so the sync checks of phase 9 and the stream of phase 15 take their
buckets' first calls before them.

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
phase 9, ``view_launches`` from phases 15 and 16, ``sharded_launches``
from phase 17); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits nonzero
and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import logging
import math
import os
import runpy
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pyqmd_tpu_torch import (
    SimConfig,
    Simulation,
    analysis,
    cli,
    ensemble_init,
    init_state,
    load_checkpoint,
    make_decay_frame_fn,
    make_frame_fn,
    make_run_fn,
    mixed_ensemble_init,
    prng,
)
from pyqmd_tpu_torch.core import decay as plain_decay
from pyqmd_tpu_torch.core import forces as plain_forces
from pyqmd_tpu_torch.core import overlap as plain_overlap
from pyqmd_tpu_torch.core import graphs, step
from pyqmd_tpu_torch.core.dynamics import (
    FrameDynamics,
    frame_dynamics,
    frame_scalars,
    scalar_values,
)
from pyqmd_tpu_torch.frame_profile import device_ms
from pyqmd_tpu_torch.kernels import _build
from pyqmd_tpu_torch.kernels.decay import DECAY_FIELDS, decay_stats_frame, decay_stats_substep
from pyqmd_tpu_torch.kernels.forces import SMALL_MAX_PARTICLES, force_step
from pyqmd_tpu_torch.kernels.overlap import overlap_step
from pyqmd_tpu_torch.kernels.substep import SUBSTEP_FIELDS, ejecta_decay_substep
from pyqmd_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    make_hybrid_frame_fn,
    make_mesh,
    make_ring_force_step,
    make_ring_frame_fn,
    make_sharded_decay_fn,
    make_sharded_frame_fn,
    make_sharded_run_fn,
    shard_ensemble,
)
from pyqmd_tpu_torch.parallel.ensemble import sharded_frame
from pyqmd_tpu_torch.render import (
    PipelinedFrameReader,
    render_frame,
    render_frame_packed,
    render_to_host,
    unpack_frame,
)
from pyqmd_tpu_torch.render.httpview import LiveViewServer
from pyqmd_tpu_torch.state import DECAY_ALPHA, DECAY_BETA_MINUS, DECAY_BETA_PLUS, PROTON
from pyqmd_tpu_torch.state import DECAY_NEUTRON_EMISSION, DECAY_PROTON_EMISSION
from pyqmd_tpu_torch.state import state_to_numpy
from pyqmd_tpu_torch.utils.checkpoint import load_checkpoint_sharded, save_checkpoint_sharded

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
READER_FRAMES, READER_DEPTH = 20, 3
HTTP_TIMEOUT = 120  # seconds, on every request
STREAM_SECONDS = 2.0
HYBRID_B = 1024  # the ring's (B, P/D, P/D) pair temporaries: 268 MB each at D = 1
RING_STEPS = 2  # substeps of the ring and hybrid frames: tests/test_parallel.py's hybrid
# A frame of the plain force step against the kernel frame: phase 5's bar.
# f32 rounding order alone moves a 1024-nucleus U-238 frame by up to 4e-4
# over 4 substeps; a single step is held to EXACT_TOL.
FRAME_TOL = 1e-3
REPO = Path(__file__).resolve().parent

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
    emit({"phase": "build", "seconds": round(build_s, 3), "library": path.name,
          "visible_devices": torch.cuda.device_count()})
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
        # static and dynamic shared memory together just past 48 KB
        ("p600", SimConfig.for_isotope(92, 146, pad_to=600), 600, 5, 100.0, 0.9),
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
        ("p600", SimConfig.for_isotope(92, 146, pad_to=600), 600, 5, 60.0, 0.9),
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
    overlap_step.launches = ejecta_decay_substep.launches = 0
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        states, metrics = fn(states, TIME_SCALE, FRAME_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"force_step": force_step.launches, "overlap_step": overlap_step.launches,
                "force_step_small": force_step.small_launches,
                "ejecta_decay_substep": ejecta_decay_substep.launches}

    assert launches["force_step"] == launches["ejecta_decay_substep"] == FRAMES * steps, launches
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
    # dt as the frame passes it, a 0-d tensor on the card: a float would
    # add a fill launch to every timed call.
    dt = torch.full((), DT, device=DEV)
    k_force_full = device_ms(lambda: force_step(pos, vel, ptype, alive, dt, cfg), DEV, 20)
    k_force = device_ms(
        lambda: force_step(pos[sub], vel[sub], ptype[sub], alive[sub], dt, cfg), DEV, 20
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
    substep = _substep_kernel(cfg, states, steps, launches["ejecta_decay_substep"], smi)
    states, _ = fn(states, TIME_SCALE, FRAME_DT)  # a replayed frame, traced
    substep.update(_in_frame_ms(lambda: fn(states, TIME_SCALE, FRAME_DT),
                                "ejecta_decay_substep_kernel", steps, substep["bound_ms"]))
    emit({"phase": "substep_kernel", "card": smi, **substep})
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
        substep,
    ]


def share(b: dict, ms: float) -> float:
    return b["bound_ms"] / ms


def _substep_kernel(cfg, states, steps: int, launches: int, smi: str) -> dict:
    """The substep kernel on the slice's own state: two substeps in place
    on a copy, each against the plain ``advance_ejecta`` + ``maybe_decay``
    on the card from the same state and key (integers, the clock's and the
    decay engine's floats and every velocity bitwise, ``ej_pos`` within
    EXACT_TOL: a fragment sits at a centre of mass summed in another
    order); then the time of one launch alone, in place, of the plain
    version, and of the frame's clone of the fields the kernel writes, at
    the slice's B; the kernel's entry of the summary."""
    sc = frame_scalars(frame_dynamics(cfg, TIME_SCALE, FRAME_DT, steps, None, cfg.physics_dt),
                       cfg, DEV)
    k3 = prng.split(states.rng, 3)
    want = states
    got = states.replace(**{f: getattr(states, f).clone() for f in SUBSTEP_FIELDS})
    err, fired = 0.0, 0
    for s in range(2):
        keys = prng.split(k3[:, 0], steps)[:, s]
        prev = want
        want = plain_decay.maybe_decay(plain_decay.advance_ejecta(want, cfg, sc), cfg, keys,
                                       sc)[0]
        assert ejecta_decay_substep(got, cfg, sc, k3, s) is got
        for f in INT_FIELDS + STATS_FLOATS + ("ej_age", "ej_life", "vel", "ej_vel", "pos",
                                              "time_passed"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (s, f)
        err = max(err, max_diff(got.ej_pos, want.ej_pos))
        fired += int((want.chain_cursor != prev.chain_cursor).sum())
    assert err <= EXACT_TOL, err
    assert fired > 0, "no decay fired in the compared substeps"

    k_ms = device_ms(lambda: ejecta_decay_substep(got, cfg, sc, k3, 5), DEV, 50)
    p_ms = device_ms(lambda: plain_decay.maybe_decay(
        plain_decay.advance_ejecta(states, cfg, sc), cfg, keys, sc), DEV, 5)
    clone_ms = device_ms(
        lambda: [getattr(states, f).clone() for f in SUBSTEP_FIELDS], DEV, 20)
    # What every nucleus moves: its ring read (pos 8, vel 8, type 4, age 4,
    # life 4, alive 1 bytes a slot) and written back (pos, age, alive: 13),
    # and half_life, z, n, ej_cursor and k3[:, 0] (32); two threefry hashes.
    b = states.batch
    sb = bound(b * (cfg.max_ejecta * (29 + 13) + 32), int_ops=2 * THREEFRY_INT_OPS * b)
    return {"name": "substep", "route": "cuda", "source": "pyqmd_tpu_torch/csrc/substep.cu",
            "replaces": "none", "launches": launches, "launches_per_frame": steps,
            "max_abs_err": err, "decays_compared": fired, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": sb["bound_ms"], "bound_by": sb["bound_by"], "share": share(sb, k_ms),
            "library_ms": None, "B": b, "clone_ms_per_frame": clone_ms}


def _in_frame_ms(call, kernel: str, per_call: int, bound_ms: float) -> dict:
    """One ``call`` under ``torch.profiler``: the launches of ``kernel``
    in its trace (``per_call`` of them) and their mean device ms, beside
    ``bound_ms``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    events = events["traceEvents"] if isinstance(events, dict) else events
    durs = [e["dur"] for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
            and kernel in e.get("name", "")]
    assert len(durs) == per_call, (kernel, len(durs))
    ms = sum(durs) / len(durs) / 1e3
    return {"in_frame_launches": len(durs), "in_frame_ms": ms,
            "in_frame_share": bound_ms / ms}


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
    overlap_step.launches = ejecta_decay_substep.launches = 0
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        states, metrics = fn(states, TIME_SCALE, FRAME_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"force_step": force_step.launches, "force_step_small": force_step.small_launches,
                "overlap_step": overlap_step.launches,
                "ejecta_decay_substep": ejecta_decay_substep.launches}
    assert launches["force_step_small"] == launches["force_step"] == FRAMES * steps, launches
    assert launches["ejecta_decay_substep"] == FRAMES * steps, launches
    assert launches["overlap_step"] == FRAMES * cfg.overlap_iterations, launches
    assert not bool(metrics["nan"].any()), "NaN in the He-4 ensemble"
    assert int(metrics["total_decay_counts"].sum()) == 0, "a stable nucleus decayed"
    assert bool(torch.isfinite(states.pos).all()) and states.pos.shape == (SLICE_B, 8, 2)
    emit({"phase": "slice", "isotope": "He-4", "B": SLICE_B, "P": cfg.max_particles,
          "frames": FRAMES, "substeps_per_frame": steps, "wall_s": wall,
          "nucleus_substeps_per_s": SLICE_B * steps * FRAMES / wall, "launches": launches,
          "total_alive": int(metrics["total_alive"]), "card": smi})

    pos, vel, ptype, alive = states.pos, states.vel, states.ptype, states.alive
    dt = torch.full((), DT, device=DEV)  # as the frame passes it (phase 4)
    k_ms = device_ms(lambda: force_step(pos, vel, ptype, alive, dt, cfg), DEV, 50)
    p_ms = device_ms(lambda: plain_forces.force_step(pos, vel, ptype, alive, DT, cfg), DEV, 5)
    err = max(max_diff(a, b) for a, b in zip(force_step(pos, vel, ptype, alive, DT, cfg),
                                             plain_forces.force_step(pos, vel, ptype, alive,
                                                                     DT, cfg)))
    assert err <= FAST_ATOL, err  # cfg runs fast_math, as the slice does
    fb = force_bound(alive)

    big = ensemble_init(cfg, HE4_BIG_B, seed=1, device=DEV)
    bp, bv, bt, ba = big.pos, big.vel, big.ptype, big.alive
    k_big = device_ms(lambda: force_step(bp, bv, bt, ba, dt, cfg), DEV, 20)
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
    overlap_step.launches = ejecta_decay_substep.launches = 0
    per_frame = []
    t0 = time.perf_counter()
    for _ in range(SIM_FRAMES):
        before = (force_step.launches, overlap_step.launches, ejecta_decay_substep.launches)
        sim.frame()
        per_frame.append((force_step.launches - before[0], overlap_step.launches - before[1],
                          ejecta_decay_substep.launches - before[2]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"force_step": force_step.launches, "force_step_small": force_step.small_launches,
                "overlap_step": overlap_step.launches,
                "ejecta_decay_substep": ejecta_decay_substep.launches}
    steps = sim.substeps_used
    assert steps == 20, steps
    assert per_frame == [(steps, 1, steps)] * SIM_FRAMES, per_frame
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
    # The first picture on a device copies the colour and label tables there,
    # and the first fused run of two frames captures its graph, which waits
    # for the card.
    render_frame(probe.state, (400.0, 400.0), 15.0, 160, 120)
    probe.run(2, fused=True)
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
    overlap_step.launches = ejecta_decay_substep.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = fused.run(SIM_FRAMES + 1, fused=True)
    torch.cuda.synchronize()
    fused_wall = time.perf_counter() - t0
    assert force_step.launches == ejecta_decay_substep.launches == (SIM_FRAMES + 1) * steps, (
        force_step.launches, ejecta_decay_substep.launches)
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
    force_step.launches = ejecta_decay_substep.launches = 0
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
    assert force_step.launches == ejecta_decay_substep.launches == frames * 20, (
        force_step.launches, ejecta_decay_substep.launches)
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


def _png_dimensions(data: bytes) -> tuple[int, int]:
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR", data[:16]
    return struct.unpack(">II", data[16:24])


def _png_size(path: Path) -> tuple[int, int]:
    return _png_dimensions(path.read_bytes())


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


def phase_rasterizer(smi: str):
    """The same evolved state drawn on the card and on the CPU; returns
    that state."""
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
    return state


def phase_packed_frames(smi: str, u238_state) -> None:
    """Packed frames on the card against ``render_frame`` and the CPU port."""
    he4 = Simulation(z=2, n=2, seed=0, pad_to=8, device=DEV)
    for _ in range(3):
        he4.frame()
    out = {"phase": "packed_frames", "card": smi, "size": "800x600"}
    cam, zoom, w, h = (400.0, 400.0), 15.0, 800, 600
    for name, state in (("u238", u238_state), ("he4", he4.state)):
        packed = render_frame_packed(state, cam, zoom, w, h)
        assert packed.is_cuda and packed.dtype == torch.uint8 and packed.shape == (h + 2, w)
        host = packed.cpu().numpy()
        k = 10 + state.ejecta_capacity
        assert host[h + 1, 0] == 1 and host[h + 1, 1] == k - 1, host[h + 1, :2]
        t0 = time.perf_counter()
        rgb = unpack_frame(host)
        unpack_ms = (time.perf_counter() - t0) * 1e3
        want = render_frame(state, cam, zoom, w, h).cpu().numpy()
        assert rgb is not None and np.array_equal(rgb, want), name
        cpu = render_frame_packed(state.to("cpu"), cam, zoom, w, h).numpy()
        diff = int((host != cpu).sum())
        assert diff <= PIXEL_DIFF_LIMIT * host.size, (name, diff)
        pack = lambda: render_frame_packed(state, cam, zoom, w, h)  # noqa: E731
        draw = lambda: render_frame(state, cam, zoom, w, h)  # noqa: E731
        out[name] = {"palette_entries": k, "live_ejecta": int(state.ej_alive.sum()),
                     "flag": int(host[h + 1, 0]), "unpacked_equals_render_frame": True,
                     "bytes_differing_from_cpu_packed": diff, "bytes": int(host.size),
                     "rgb_bytes": int(want.size),
                     "packed_ms_host_paced": device_ms(pack, DEV, 20),
                     "packed_ms_device": device_ms(pack, DEV, 1),
                     "render_frame_ms_host_paced": device_ms(draw, DEV, 20),
                     "render_frame_ms_device": device_ms(draw, DEV, 1),
                     "unpack_on_host_ms": unpack_ms}
    try:
        render_frame_packed(u238_state, cam, zoom, 40, 30)
    except ValueError as e:
        out["width_40"] = f"ValueError: {e}"
    else:
        raise AssertionError("a 74-entry palette fitted a 40-pixel row")
    emit(out)


@contextlib.contextmanager
def no_synchronising_call():
    """PyTorch's synchronisation check set to raise inside the block."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _pinned_buffers(reader) -> list:
    """The addresses of the host buffers a reader holds, ring by ring."""
    return [b.data_ptr() for ring, _ in reader._rings.values() for b in ring]


def phase_frame_reader(smi: str) -> None:
    """The pipelined reader behind ``frame()`` on one U-238 nucleus."""
    sim = Simulation(z=92, n=146, seed=0, pad_to=128, device=DEV)
    sim.set_preset("billion")
    kinds = {
        "rgb_64x44": (lambda: sim.render_fit_device(64, 44), lambda a: a),
        "packed_800x600": (
            lambda: render_frame_packed(sim.state, tuple(sim.camera), sim.zoom, 800, 600),
            unpack_frame),
    }
    out = {"phase": "frame_reader", "isotope": "U-238", "frames": READER_FRAMES,
           "depth": READER_DEPTH, "card": smi}
    for name, (draw, decode) in kinds.items():
        sim.frame()
        draw()  # the first picture copies the colour tables to the card
        torch.cuda.synchronize()

        def blocking() -> float:
            t0 = time.perf_counter()
            for _ in range(READER_FRAMES // 2):
                sim.frame()
                decode(draw().cpu().numpy())
            return (time.perf_counter() - t0) / (READER_FRAMES // 2) * 1e3

        def pipelined(depth: int, frames: int):
            """ms per delivered frame, the device frames, what came out of
            each ``submit`` (copied at once: a raw frame is valid until the
            next one), the flushed tail, and the reader."""
            reader = PipelinedFrameReader(depth=depth, decode=decode)
            device, handed, rings = [], [], []
            t0 = time.perf_counter()
            for _ in range(frames):
                sim.frame()
                with no_synchronising_call():  # waiting on its own event is none
                    frame = draw()
                    got = reader.submit(frame)
                device.append(frame)
                handed.append(None if got is None else got.copy())
                rings.append(_pinned_buffers(reader))
            tail = [t.copy() for t in reader.flush()]
            ms = (time.perf_counter() - t0) / frames * 1e3
            return ms, device, handed, tail, rings

        blocking_ms = [blocking()]
        depth1_ms = pipelined(1, READER_FRAMES // 2)[0]
        ms, device, handed, tail, rings = pipelined(READER_DEPTH, READER_FRAMES)
        blocking_ms.append(blocking())
        assert [g is None for g in handed] == (
            [True] * READER_DEPTH + [False] * (READER_FRAMES - READER_DEPTH)), name
        assert len(tail) == READER_DEPTH, (name, len(tail))
        delivered = [g for g in handed if g is not None] + tail
        assert len(delivered) == READER_FRAMES
        for i, (got, frame) in enumerate(zip(delivered, device)):
            want = decode(frame.cpu().numpy())  # the blocking readback of the same device frame
            assert np.array_equal(got, want), f"{name}: frame {i} differs"
        assert len({d.tobytes() for d in delivered}) > 1, "every frame was the same picture"
        # allocated at the first submit and never again: the same buffers after every frame
        assert all(r == rings[0] for r in rings) and len(set(rings[0])) == READER_DEPTH + 1, rings
        out[name] = {"bytes_per_frame": int(device[0].numel()),
                     "handed_out": READER_FRAMES - READER_DEPTH, "flushed": len(tail),
                     "bitwise_equal_to_blocking_readback": True,
                     "pinned_buffers": len(rings[0]),
                     "synchronising_calls_in_draw_and_submit": 0,
                     "ms_per_frame_depth_3": ms, "ms_per_frame_depth_1": depth1_ms,
                     "ms_per_frame_blocking_before_and_after": blocking_ms}
    on_cpu = PipelinedFrameReader(depth=1, decode=lambda a: a)
    assert on_cpu.submit(torch.zeros(44, 64, 3, dtype=torch.uint8)) is None
    assert not _pinned_buffers(on_cpu) and len(on_cpu.flush()) == 1
    out["pinned_buffers_for_a_cpu_tensor"] = len(_pinned_buffers(on_cpu))
    emit(out)


def _http(server, path: str) -> bytes:
    return urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}",
                                  timeout=HTTP_TIMEOUT).read()


def _http_status(server) -> dict:
    def refuse(constant):
        raise AssertionError(f"/status is not strict JSON: {constant}")

    return json.loads(_http(server, "/status"), parse_constant=refuse)


def _http_error(server, path: str) -> int:
    try:
        _http(server, path)
    except urllib.error.HTTPError as e:
        return e.code
    raise AssertionError(f"{path} was answered 200")


def _read_stream(server, seconds: float, parts: list) -> None:
    """Read ``/stream`` for ``seconds``; appends the digest of every whole
    part to ``parts``."""
    req = urllib.request.urlopen(f"http://127.0.0.1:{server.port}/stream", timeout=HTTP_TIMEOUT)
    try:
        assert "multipart/x-mixed-replace" in req.headers["Content-Type"]
        buf, t0 = b"", time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            buf += req.read1(65536)
    finally:
        req.close()
    for part in buf.split(b"--pyqmd-frame")[1:-1]:
        png = part.split(b"\r\n\r\n", 1)[1]
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        parts.append(hashlib.sha1(png).hexdigest())


def _zero_view_counts() -> None:
    force_step.launches = force_step.small_launches = overlap_step.launches = 0
    ejecta_decay_substep.launches = 0


def phase_viewer(smi: str) -> dict:
    """The HTTP viewer on the card; returns the kernels' launches under it."""
    sim = Simulation(z=92, n=146, seed=0, pad_to=128, device=DEV)
    sim.set_preset("billion")
    server = LiveViewServer(sim, port=0, fps=30, width=800, height=600)
    thread = server.start_background()
    try:
        page = _http(server, "/")
        assert b"/stream" in page and b"/control" in page
        for _ in range(3):
            assert _png_dimensions(_http(server, "/frame")) == (800, 600)
        status = _http_status(server)
        assert status["isotope"] == "U-238" and status["backend"] == "cuda", status
        assert json.loads(_http(server, "/control?do=faster")) == {"ok": True}
        faster = _http_status(server)
        assert faster["time_scale"] == status["time_scale"] * 10, faster
        _http(server, "/control?do=decay")
        decayed = _http_status(server)
        assert sum(decayed["decay_counts"]) == sum(status["decay_counts"]) + 1, decayed
        assert _http_error(server, "/control?do=nope") == 400
        assert _http_error(server, "/nope") == 404

        server.pump_frame(-1)  # the first frame, before a reader connects
        with server.lock:
            _zero_view_counts()
            frames_before = sim.frame_count
        readers = [[], []]
        threads = [threading.Thread(target=_read_stream, args=(server, STREAM_SECONDS, parts))
                   for parts in readers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(HTTP_TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        with server.lock:  # frame() runs under the lock: the counts belong together
            pumped = sim.frame_count - frames_before
            launches = {"force_step": force_step.launches,
                        "force_step_small": force_step.small_launches,
                        "overlap_step": overlap_step.launches,
                        "ejecta_decay_substep": ejecta_decay_substep.launches}
            steps = sim.substeps_used
    finally:
        server.close()
    thread.join(10)
    assert not thread.is_alive(), "the server's thread did not end"
    assert steps == 20 and pumped >= 2, (steps, pumped)
    assert launches["force_step"] == pumped * steps and launches["force_step_small"] == 0, launches
    assert launches["overlap_step"] == pumped * sim.cfg.overlap_iterations, launches
    assert launches["ejecta_decay_substep"] == pumped * steps, launches
    both = set(readers[0]) & set(readers[1])
    distinct = len(set(readers[0]) | set(readers[1]))
    assert len(both) >= 2, (len(readers[0]), len(readers[1]), len(both))
    runs = []
    for mine in readers:  # while both are connected: the same frames in the same order
        at = [mine.index(p) for p in both]
        runs.append(mine[min(at):max(at) + 1])
    assert runs[0] == runs[1] and len(runs[0]) == len(both), (runs, len(both))
    # one cadence: the frames made, not twice that (one may be made while a reader closes)
    assert distinct - 1 <= pumped <= distinct + 2, (pumped, distinct)
    out = {"phase": "viewer", "isotope": "U-238", "size": "800x600", "fps_asked": 30,
           "stream_seconds": STREAM_SECONDS, "frames_pumped": pumped,
           "frames_to_reader_a": len(readers[0]), "frames_to_reader_b": len(readers[1]),
           "frames_shared_in_one_order": len(both), "distinct_frames": distinct,
           "frames_per_second_to_a_stream_reader":
               max(len(readers[0]), len(readers[1])) / STREAM_SECONDS,
           "launches": launches, "status": decayed, "card": smi}

    # He-4 (P=8): the viewer's frames run the sub-warp force kernel. A lone
    # He-4 nucleus's first frame captures its graph (a third of a second),
    # so another Simulation of the same bucket takes that frame first.
    warm = Simulation(z=2, n=2, seed=1, pad_to=8, device=DEV)
    warm.set_preset("billion")
    warm.frame()
    he4 = Simulation(z=2, n=2, seed=0, pad_to=8, device=DEV)
    he4.set_preset("billion")
    server = LiveViewServer(he4, port=0, fps=30, width=800, height=600)
    server.start_background()
    try:
        assert _http_status(server)["half_life"] is None  # inf is null in strict JSON
        force_step.small_launches = 0
        parts = []
        _read_stream(server, STREAM_SECONDS / 2, parts)
        with server.lock:
            small, he4_frames = force_step.small_launches, he4.frame_count
    finally:
        server.close()
    assert he4_frames >= 2 and small == he4_frames * he4.substeps_used, (small, he4_frames)
    launches["force_step_small"] = small
    out["he4"] = {"frames_pumped": he4_frames, "force_step_small_launches": small,
                  "frames_to_a_reader": len(parts)}

    ens = Simulation(z=92, n=146, ensemble=SLICE_B, pad_to=128, seed=0, device=DEV)
    ens.set_preset("billion")
    server = LiveViewServer(ens, port=0, fps=30, width=800, height=600)
    server.start_background()
    try:
        assert _http_error(server, "/control?do=decay") == 400
        before = (force_step.launches, ejecta_decay_substep.launches)
        seq, png, _ = server.pump_frame(-1)
        assert seq == 1 and _png_dimensions(png) == (800, 600)
        assert (force_step.launches - before[0] == ejecta_decay_substep.launches - before[1]
                == ens.substeps_used == 20)
        status = _http_status(server)
        assert status["ensemble"] == SLICE_B and status["alive"] > 0, status
    finally:
        server.close()
    out["ensemble"] = {"B": SLICE_B, "decay_control": 400, "status": status}
    emit(out)
    return launches


def phase_cli_live_and_examples(smi: str) -> int:
    """``watch`` and ``--serve`` through ``cli.main``, then the example
    scripts; returns the decay frame kernel's launches."""
    stdin = sys.stdin
    sys.stdin = io.StringIO("watch 0.5\nquit\n")
    try:
        before = force_step.launches
        watched = _cli(["--isotope", "U-238", "--time-scale", "1e9yr", "-i", "-q"])
    finally:
        sys.stdin = stdin
    watch_frames = watched.count("\x1b[2J\x1b[H")
    assert watch_frames >= 1 and "unknown command" not in watched and "error:" not in watched
    assert "\x1b[38;2;" in watched and "substeps=20" in watched
    watch_launches = force_step.launches - before
    assert watch_launches >= 20, watch_launches

    # --serve: the real accept loop, left by the interrupt a user's Ctrl-C raises.
    served = {}
    real_loop = LiveViewServer.serve_forever

    def one_frame_then_interrupt(self):
        thread = threading.Thread(target=real_loop, args=(self,), daemon=True)
        thread.start()
        try:
            served["png"] = _png_dimensions(_http(self, "/frame"))
            served["backend"] = _http_status(self)["backend"]
        finally:
            self.close()
            thread.join(10)
        served["thread_ended"] = not thread.is_alive()
        raise KeyboardInterrupt

    LiveViewServer.serve_forever = one_frame_then_interrupt
    try:
        _cli(["--isotope", "C-14", "--serve", "0", "-q"])
    finally:
        LiveViewServer.serve_forever = real_loop
    assert served == {"png": (800, 600), "backend": "cuda", "thread_ended": True}, served

    # Every example on its default device, each in its own directory: four as
    # processes of their own, all at once (the Bateman theory curve at 6 time
    # points, not 21: each is a 1000x1000 matrix exponential on the host), and
    # survival_curve.py meanwhile in this process, where its decay-kernel
    # launches can be read.
    args = {"decay_chain_movie.py": ["--frames", "40"],
            "bateman_vs_ensemble.py": ["--frames", "5"]}
    # sharded_survival.py runs in phase 17, with the sharded path.
    scripts = sorted(p.name for p in (REPO / "examples_torch").glob("*.py")
                     if p.name != "sharded_survival.py")
    assert len(scripts) == 5, scripts
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name in scripts:
            cwd = Path(tmp) / name.removesuffix(".py")
            cwd.mkdir()
            if name == "survival_curve.py":
                continue
            procs[name] = subprocess.Popen(
                [sys.executable, str(REPO / "examples_torch" / name)] + args.get(name, []),
                cwd=cwd, env=dict(os.environ, OMP_NUM_THREADS="1"),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        outputs = {}
        argv, cwd = sys.argv, os.getcwd()
        try:
            decay_stats_frame.launches = 0
            sys.argv = ["survival_curve.py"]
            os.chdir(Path(tmp) / "survival_curve")
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                runpy.run_path(str(REPO / "examples_torch" / "survival_curve.py"),
                               run_name="__main__")
            outputs["survival_curve.py"] = printed.getvalue()
            decay_launches = decay_stats_frame.launches
            rows = (Path(tmp) / "survival_curve" / "c14_survival.csv").read_text().splitlines()
            for name, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=300)
                assert proc.returncode == 0, (name, stdout[-2000:], stderr[-2000:])
                outputs[name] = stdout
        finally:
            sys.argv = argv
            os.chdir(cwd)
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
        examples_s = time.perf_counter() - t0
        movie = (Path(tmp) / "decay_chain_movie" / "u238_chain.png").read_bytes()
        assert b"acTL" in movie and _png_dimensions(movie) == (480, 360)
    assert decay_launches == 30 and len(rows) == 32, (decay_launches, len(rows))

    text = outputs["survival_curve.py"]
    fit = json.loads(text[:text.rindex("}") + 1])
    assert fit["rel_error"] < 0.01 and fit["batch"] == 16384, fit
    worst = float(outputs["bateman_vs_ensemble.py"].split(
        "worst absolute population error:")[1].split()[0])
    assert worst < 0.05, worst  # 4 sigma of a population share at 8192 nuclei
    rows = [l for l in outputs["mixed_population.py"].splitlines() if "Rn-222:" in l]
    assert len(rows) == 9 and "Rn-222:256" in rows[0], rows
    # leapfrog_accuracy.py ran the sub-warp force kernel, one launch per step:
    # halving dt halves Euler's error and quarters leapfrog's, and leapfrog
    # comes back from 60 steps out and 60 back to within four f32 steps at 7.
    orders = [[float(c) for c in l.split()]
              for l in outputs["leapfrog_accuracy.py"].splitlines() if l.strip().startswith("0.0")]
    assert len(orders) == 3, orders
    euler_ratio, leapfrog_ratio = (orders[0][k] / orders[1][k] for k in (1, 2))
    assert 1.7 < euler_ratio < 2.3 and 3.0 < leapfrog_ratio < 5.0, orders
    drift = {l.split()[0]: float(l.split()[1])
             for l in outputs["leapfrog_accuracy.py"].splitlines()
             if l.strip().startswith(("euler ", "leapfrog "))}
    assert drift["leapfrog"] < 2e-6 < 1e-2 < drift["euler"], drift
    assert "wrote u238_chain.png (5 frames)" in outputs["decay_chain_movie.py"]
    emit({"phase": "cli_live_and_examples", "watch_frames_printed": watch_frames,
          "watch_force_launches": watch_launches, "serve": served,
          "examples_wall_s_all_at_once": examples_s,
          "c14_survival_fit": {k: fit[k] for k in ("batch", "fitted_half_life_s", "rel_error",
                                                   "final_survival")},
          "c14_decay_frame_launches": decay_launches,
          "pb214_worst_abs_population_error": worst,
          "mixed_population_last_row": rows[-1].strip(),
          "leapfrog_error_ratio_on_halving_dt": leapfrog_ratio,
          "euler_error_ratio_on_halving_dt": euler_ratio,
          "leapfrog_table": orders, "round_trip_drift": drift,
          "movie_last_line": outputs["decay_chain_movie.py"].strip().splitlines()[-1],
          "card": smi})
    return decay_launches


def _states_equal(a, b, what: str) -> None:
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), (what, f.name)


def _state_diff(a, b, what: str) -> float:
    """Integer fields equal; returns the largest pos/vel difference."""
    for f in INT_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), (what, f)
    return max(max_diff(a.pos, b.pos), max_diff(a.vel, b.vel))


# The calls of one graph bucket in phase 17: the first captures, then a
# replay at the same scalars, at a hundredth of the time scale and at
# another frame interval (time_scale > 1 throughout).
BUCKET_CALLS = ((TIME_SCALE, FRAME_DT), (TIME_SCALE, FRAME_DT), (TIME_SCALE / 100, FRAME_DT),
                (TIME_SCALE, 1 / 30))


@contextlib.contextmanager
def timed_captures():
    """Every graph capture inside the block timed on the host, the card
    synchronised around it; yields the list of seconds."""
    record, capture_s = graphs._record, []

    def timed_record(fn, dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = record(fn, dev)
        torch.cuda.synchronize()
        capture_s.append(time.perf_counter() - t0)
        return graph

    graphs._record = timed_record
    try:
        yield capture_s
    finally:
        graphs._record = record


def _metrics_equal(a: dict, b: dict, what: str) -> None:
    assert set(a) == set(b), (what, sorted(a), sorted(b))
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


def phase_sharded(smi: str) -> dict:
    """17: the sharded path in a world of one; returns each kernel's
    launches from the sharded calls alone."""
    mesh = make_mesh()
    world, backend = dist.get_world_size(), dist.get_backend()
    assert (world, backend) == (1, "nccl"), (world, backend)
    where = {"world": world, "backend": backend, "card": smi}
    launches = dict.fromkeys(("force", "force_small", "overlap", "decay_stats", "substep"), 0)
    last = {}

    def sharded(fn, *args):
        """A call of the sharded path, its kernel launches counted (and
        kept in ``last``)."""
        force_step.launches = force_step.small_launches = 0
        overlap_step.launches = decay_stats_frame.launches = ejecta_decay_substep.launches = 0
        out = fn(*args)
        last.update(force=force_step.launches - force_step.small_launches,
                    force_small=force_step.small_launches, overlap=overlap_step.launches,
                    decay_stats=decay_stats_frame.launches,
                    substep=ejecta_decay_substep.launches)
        for k in launches:
            launches[k] += last[k]
        return out

    def timed_ms(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def turns(forms: dict, order: tuple, st) -> tuple[dict, dict]:
        """ms per frame of each form in ``order``, FRAMES frames a turn
        at 1e9 years per second from ``st``, and each form's last state."""
        ms, out = {name: [] for name in forms}, {}
        for name in order:
            x = st
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FRAMES):
                x, _ = sharded(forms[name], x, TIME_SCALE, FRAME_DT)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) / FRAMES * 1e3)
            out[name] = x
        return ms, out

    def graph_call(fn, i, *args):
        """A factory's call; a replay (any call but the bucket's first)
        under PyTorch's synchronisation check."""
        if i == 0:
            return sharded(fn, *args)
        torch.cuda.synchronize()
        with no_synchronising_call():
            return sharded(fn, *args)

    # Full-physics frames: the sharded frame (a graph replay of the
    # rank's bucket, then the all_reduce) against the eager sharded form
    # and the bare graph loop from one seed, over the calls of one bucket;
    # then ms per frame in turns. A fresh factory cache: the capture is the
    # sharded frame's own.
    step.make_frame_fn.cache_clear()
    for isotope, z, n, pad in (("U-238", 92, 146, 128), ("He-4", 2, 2, 8)):
        cfg = SimConfig.for_isotope(z, n, pad_to=pad)
        steps = cfg.num_substeps(FRAME_DT, TIME_SCALE)
        init = ensemble_init(cfg, SLICE_B, seed=0, device=DEV)
        local = shard_ensemble(init, mesh)
        frame = make_sharded_frame_fn(cfg, steps, mesh)
        eager = sharded_frame(
            lambda st, ts, fdt, cfg=cfg, steps=steps: step.ensemble_step(st, cfg, ts, fdt, steps),
            cfg, mesh, DATA_AXIS)
        bare = make_frame_fn(cfg, steps, batched=True)
        a = e = local
        b = init
        per_frame = None
        with timed_captures() as capture_s:
            for i, (ts, fdt) in enumerate(BUCKET_CALLS):
                a, m = graph_call(frame, i, a, ts, fdt)
                per_frame = dict(last)
                assert per_frame["substep"] == steps, (isotope, i, per_frame)
                e, me = sharded(eager, e, ts, fdt)
                assert last == per_frame, (isotope, i, last, per_frame)
                # The sharded frames pass no raw physics dt, as the reference's do.
                b, mb = bare(b, ts, fdt, cfg.effective_dt(), None)
                _states_equal(a, e, f"{isotope} sharded graph frame {i} vs eager sharded frame")
                _metrics_equal(m, me, f"{isotope} sharded graph frame {i} metrics")
                _states_equal(a, b, f"{isotope} sharded graph frame {i} vs bare graph loop")
                assert torch.equal(m["total_decay_counts"], mb["total_decay_counts"])
                assert int(m["total_alive"]) == int(mb["total_alive"])
        assert frame.graphs.captures == 1 and len(frame.graphs.graphs) == 1, isotope
        assert len(capture_s) == 1, capture_s  # the bare loop replays the same bucket
        pool = _pool_bytes()
        survivors = int(((a.z == z) & (a.n == n)).sum())
        assert int(m["survivors"]) == survivors, (int(m["survivors"]), survivors)
        decays = int(m["total_decay_counts"].sum())
        assert (decays > 0) if z > 2 else (decays == 0 and survivors == SLICE_B), decays
        forms = {"eager": eager, "graph": frame,
                 "bare_graph": lambda st, ts, fdt: bare(st, ts, fdt, cfg.effective_dt(), None)}
        ms, out = turns(forms, ("eager", "graph", "bare_graph", "graph", "eager"), local)
        _states_equal(out["graph"], out["eager"], f"{isotope} turns")
        line = {"phase": "sharded", "case": f"{isotope.lower()}_frame", "B": SLICE_B,
                "P": cfg.max_particles, "substeps_per_frame": steps,
                "calls_bitwise": len(BUCKET_CALLS),
                "time_scales": sorted({c[0] for c in BUCKET_CALLS}),
                "frame_dts": sorted({c[1] for c in BUCKET_CALLS}),
                "bitwise_vs_eager_sharded": True, "bitwise_vs_bare_graph_loop": True,
                "captures": frame.graphs.captures, "capture_s": capture_s,
                "synchronising_calls_in_a_replay": 0, "launches_per_frame": per_frame,
                "survivors": survivors, "decays": decays,
                "ms_per_frame_eager_sharded": ms["eager"], "ms_per_frame_graph": ms["graph"],
                "ms_per_frame_bare_graph": ms["bare_graph"], "pool_bytes": pool, **where}
        if z > 2:
            run = make_sharded_run_fn(cfg, steps, FRAMES, mesh)
            (r, mr), t = timed_ms(sharded, run, local, TIME_SCALE, FRAME_DT)
            _states_equal(r, out["graph"], "sharded run vs sharded frame loop")
            assert int(mr["survivors"]) == int(((r.z == z) & (r.n == n)).sum())
            line.update(run_bitwise_vs_frame_loop=True, run_first_call_ms_per_frame=t / FRAMES)
        emit(line)
        del init, local, a, b, e, out

    # The decay-statistics slice, sharded: C-14 at 2M, the fit from the
    # summed survivors.
    cfg = SimConfig.for_isotope(6, 8, pad_to=8, max_chain_log=8)
    hl = analysis.half_life_host(6, 8)
    sim_dt, stats_frames = 2.0 * hl / 20, 20
    init = ensemble_init(cfg, C14_B, seed=0, device=DEV)
    a = shard_ensemble(init, mesh)
    fn = make_sharded_decay_fn(cfg, 10, mesh)
    bare = make_decay_frame_fn(cfg, 10)
    b, ms, bare_ms, before = init, [], [], launches["decay_stats"]
    for _ in range(stats_frames):
        (a, m), t = timed_ms(sharded, fn, a, sim_dt, 1.0)
        ms.append(t)
        (b, _), t = timed_ms(bare, b, sim_dt, 1.0)
        bare_ms.append(t)
    frame_launches = launches["decay_stats"] - before
    assert frame_launches == stats_frames, frame_launches
    _states_equal(a, b, "sharded decay frame vs bare decay loop")
    del init, b
    surv = int(m["survivors"]) / C14_B
    fit = math.log(2) * 2.0 * hl / -math.log(surv)
    err = abs(fit - hl) / hl
    assert err < 0.01, err
    emit({"phase": "sharded", "case": "c14_decay", "B": C14_B, "frames": stats_frames,
          "substeps_per_frame": 10, "frame_kernel_launches": frame_launches,
          "bitwise_vs_bare_loop": True, "survival": surv,
          "fitted_half_life_years": fit / 3.15576e7, "rel_error": err,
          "ms_per_frame_sharded": [round(t, 3) for t in ms],
          "ms_per_frame_bare": [round(t, 3) for t in bare_ms], **where})

    # The sharded checkpoint of that state, and one more frame from each.
    nbytes_state = sum(getattr(a, f.name).numel() * getattr(a, f.name).element_size()
                       for f in dataclasses.fields(a))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "c14_2m")
        _, save_ms = timed_ms(save_checkpoint_sharded, path, a, cfg, mesh)
        nbytes = sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())
        (back, cfg_back), load_ms = timed_ms(load_checkpoint_sharded, path, a, mesh)
    assert cfg_back == cfg
    _states_equal(back, a, "sharded checkpoint")
    nxt, _ = sharded(fn, a, sim_dt, 1.0)
    nxt_back, _ = sharded(fn, back, sim_dt, 1.0)
    _states_equal(nxt_back, nxt, "a frame from the restored state")
    emit({"phase": "sharded", "case": "checkpoint", "B": C14_B, "fields_bitwise": True,
          "next_frame_bitwise": True, "save_s": save_ms / 1e3, "load_s": load_ms / 1e3,
          "bytes_on_disk": nbytes, "state_bytes": nbytes_state, **where})
    del a, back, nxt, nxt_back

    # The ring and the hybrid frame, exact math. One force step through the
    # ring against the kernel's at EXACT_TOL, for one nucleus and for the
    # hybrid's batch. Then each factory's frames over the calls of one
    # bucket (the first captures, the ring's collectives inside the graph):
    # every replay bitwise the eager frame (the bare frame with the ring
    # step), the first also bitwise the frame with the plain force step (a
    # ring of one adds no rounding); against the kernel frame the integer
    # fields equal in every frame and pos/vel within FRAME_TOL after the
    # first (later frames' differences printed only). Then ms per frame in
    # turns.
    exact = dataclasses.replace(SimConfig.for_isotope(92, 146, pad_to=128), fast_math=False)
    model = make_mesh((1,), (MODEL_AXIS,))
    one = init_state(exact, seed=0, device=DEV)
    before = dict(launches)
    hmesh = make_mesh((1, 1), (DATA_AXIS, MODEL_AXIS))
    init = ensemble_init(exact, HYBRID_B, seed=0, device=DEV)
    force_err = {}
    for name, mesh_, st in (("ring", model, one), ("hybrid", hmesh, init)):
        rp, rv = sharded(make_ring_force_step(exact, mesh_), st.pos, st.vel, st.ptype,
                         st.alive, DT)
        kp, kv = force_step(st.pos, st.vel, st.ptype, st.alive, DT, exact)
        force_err[name] = max(max_diff(rp, kp), max_diff(rv, kv))
        assert force_err[name] <= EXACT_TOL, (name, force_err)

    def single(st, f, ts, fdt):
        return step.simulate_frame(st, exact, ts, fdt, RING_STEPS, force_step_fn=f)

    def batched(st, f, ts, fdt):
        return step.ensemble_step(st, exact, ts, fdt, RING_STEPS, force_step_fn=f)

    ring_step = make_ring_force_step(exact, model)
    hybrid_step = make_ring_force_step(exact, hmesh)
    cases = (("ring", make_ring_frame_fn(exact, RING_STEPS, model),
              lambda st, ts, fdt: single(st, ring_step, ts, fdt), single, one),
             ("hybrid", make_hybrid_frame_fn(exact, RING_STEPS, hmesh),
              sharded_frame(lambda st, ts, fdt: batched(st, hybrid_step, ts, fdt),
                            exact, hmesh, DATA_AXIS), batched, shard_ensemble(init, hmesh)))
    line = {"phase": "sharded", "case": "ring_and_hybrid", "P": exact.max_particles,
            "substeps_per_frame": RING_STEPS, "hybrid_B": HYBRID_B,
            "calls_bitwise": len(BUCKET_CALLS),
            "time_scales": sorted({c[0] for c in BUCKET_CALLS}),
            "frame_dts": sorted({c[1] for c in BUCKET_CALLS}),
            "force_step_max_abs_err_vs_kernel": force_err}
    for name, frame, eager, dense, st in cases:
        pool_before = _pool_bytes()
        out = want = kern = st
        kernel_ms, errs, per_frame = [], [], None
        with timed_captures() as capture_s:
            for i, (ts, fdt) in enumerate(BUCKET_CALLS):
                out, m = graph_call(frame, i, out, ts, fdt)
                per_frame = dict(last)
                want, wm = sharded(eager, want, ts, fdt)
                assert last == per_frame, (name, i, last, per_frame)
                _states_equal(out, want, f"{name} graph frame {i} vs eager frame")
                _metrics_equal(m, wm, f"{name} graph frame {i} metrics")
                if i == 0:
                    plain, _ = dense(st, plain_forces.force_step, ts, fdt)
                    _states_equal(out, plain, f"{name} frame vs the plain force step's frame")
                (kern, km), t = timed_ms(dense, kern, None, ts, fdt)
                kernel_ms.append(t)
                errs.append(_state_diff(out, kern, f"{name} frame vs kernel frame"))
                if name == "hybrid":
                    assert torch.equal(m["total_decay_counts"], km["total_decay_counts"])
                    assert int(m["survivors"]) == int(((kern.z == 92) & (kern.n == 146)).sum())
        assert errs[0] <= FRAME_TOL, (name, errs)
        assert frame.graphs.captures == 1 == len(capture_s), (name, capture_s)
        # The ring replaces the force kernel; the overlap kernel still runs.
        assert per_frame["force"] == 0 and per_frame["overlap"] == exact.overlap_iterations, (
            name, per_frame)
        assert per_frame["substep"] == RING_STEPS, (name, per_frame)
        pool = _pool_bytes()
        ms, last_states = turns({"eager": eager, "graph": frame}, ("eager", "graph", "eager"), st)
        _states_equal(last_states["graph"], last_states["eager"], f"{name} turns")
        line.update({f"{name}_bitwise_vs_eager_frame": True,
                     f"{name}_bitwise_vs_plain_force_frame": True,
                     f"{name}_max_abs_err_vs_kernel_frame": errs,
                     f"{name}_captures": frame.graphs.captures, f"{name}_capture_s": capture_s,
                     f"{name}_launches_per_frame": per_frame,
                     f"{name}_synchronising_calls_in_a_replay": 0,
                     f"{name}_ms_per_frame_eager": ms["eager"],
                     f"{name}_ms_per_frame_graph": ms["graph"],
                     f"{name}_kernel_frame_ms_per_frame": kernel_ms,
                     f"{name}_pool_bytes_before_capture": pool_before,
                     f"{name}_pool_bytes": pool})
        del out, want, kern, last_states
    ring_launches = {k: launches[k] - before[k] for k in launches}
    assert ring_launches["force"] == 0, ring_launches
    emit({**line, "launches": ring_launches, **where})
    del init, st, cases, frame, eager
    gc.collect()  # the ring's graphs hold NCCL launches: gone before their group
    dist.destroy_process_group()

    # The example on its default device: one rank per visible card.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(REPO / "examples_torch" / "sharded_survival.py")],
            cwd=tmp, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        example_s = time.perf_counter() - t0
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    lines = proc.stdout.strip().splitlines()
    n_cards = torch.cuda.device_count()
    assert lines[0] == f"{1024 * n_cards} C-14 nuclei over {n_cards} devices (nccl)", lines
    assert lines[1].startswith("survival after 2 T1/2: ") and len(lines) == 3, lines
    emit({"phase": "sharded", "case": "example", "printed": lines, "wall_s": example_s,
          "sharded_launches": launches, **where})
    assert all(v > 0 for v in launches.values()), launches
    return launches


GRAPH_CASES = (("U-238", (92, 146), 128, SLICE_B), ("He-4", (2, 2), 8, SLICE_B),
               ("U-238 nucleus", (92, 146), 128, 1))
GRAPH_TURN_FRAMES = 5  # frames per turn of the timing (eager, graph, frame(), graph, eager)


def _pool_bytes() -> int:
    """Bytes the card holds for the shared memory pool of the graphs."""
    pool = tuple(graphs.shared(DEV).pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool)


def _counts() -> tuple:
    return (force_step.launches, force_step.small_launches, overlap_step.launches,
            ejecta_decay_substep.launches)


def _graph_case(name, zn, pad_to, b, capture_s: list, smi: str) -> dict:
    """One case of phase 18; see :func:`phase_graphs`."""
    from torch.profiler import ProfilerActivity, profile

    step.make_frame_fn.cache_clear()
    step.make_run_fn.cache_clear()
    cfg = SimConfig.for_isotope(*zn, pad_to=pad_to)
    batched = b > 1
    bare = step.ensemble_step if batched else step.simulate_frame
    fn = make_frame_fn(cfg, 20, batched)
    init = ensemble_init(cfg, b, seed=11, device=DEV)

    def eager(st, ts=TIME_SCALE, fdt=FRAME_DT):
        return bare(st, cfg, ts, fdt, 20, cfg.effective_dt(), cfg.physics_dt)

    # The first call: the eager warm-up frame, returned, and the capture.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_st, _ = fn(init, TIME_SCALE, FRAME_DT)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    assert fn.graphs.captures == 1 and len(capture_s) == 1, capture_s
    e_st, _ = eager(init)
    _states_equal(g_st, e_st, f"{name} first call")
    pool_after_frame = _pool_bytes()

    # Replays against eager frames, every field and metric bitwise: three
    # at 1e9 years per second, then 1e7 years per second, then 1/30 s.
    calls = [(TIME_SCALE, FRAME_DT)] * 3 + [(TIME_SCALE / 100, FRAME_DT), (TIME_SCALE, 1 / 30)]
    per_frame = None
    for i, (ts, fdt) in enumerate(calls):
        before = _counts()
        e_st, em = eager(e_st, ts, fdt)
        eager_counts = [a - c for a, c in zip(_counts(), before)]
        before = _counts()
        if i == 0:
            with no_synchronising_call():
                g_st, gm = fn(g_st, ts, fdt)
        else:
            g_st, gm = fn(g_st, ts, fdt)
        graph_counts = [a - c for a, c in zip(_counts(), before)]
        assert graph_counts == eager_counts, (name, i, graph_counts, eager_counts)
        _states_equal(g_st, e_st, f"{name} replay {i}")
        assert set(gm) == set(em) and all(torch.equal(gm[k], em[k]) for k in em), (name, i)
        per_frame = graph_counts
    assert fn.graphs.captures == 1 and len(capture_s) == 1, (name, capture_s)
    assert per_frame[0] == per_frame[3] == 20 and per_frame[2] == 1, per_frame
    assert per_frame[1] == (20 if cfg.max_particles <= SMALL_MAX_PARTICLES else 0), per_frame

    # The fused run of three frames: its first call (the eager frame, the
    # capture, two replays), then three replays; each against three eager
    # frames.
    run = make_run_fn(cfg, 20, 3, batched)
    r_st = g_st
    fused_ms = []
    for _ in range(2):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_st, rm = run(r_st, TIME_SCALE, FRAME_DT)
        torch.cuda.synchronize()
        fused_ms.append((time.perf_counter() - t0) / 3 * 1e3)
        run_counts = [a - c for a, c in zip(_counts(), before)]
        for _ in range(3):
            e_st, em = eager(e_st)
        _states_equal(r_st, e_st, f"{name} fused run")
        assert all(torch.equal(rm[k], em[k]) for k in em), name
        assert run_counts == [3 * c for c in per_frame], (run_counts, per_frame)
    assert run.graphs.captures == 1 and len(capture_s) == 2, capture_s
    pool_after_run = _pool_bytes()

    # Simulation.frame() on the graphs, after its own first frame (and a
    # drain of the lone nucleus's decay log, which reads the card).
    sim = Simulation(z=zn[0], n=zn[1], ensemble=b if batched else None, pad_to=pad_to, seed=12,
                     device=DEV)
    sim.set_preset("billion")
    sim.nan_check_interval = 0
    sim.frame()
    sim.decay_log
    torch.cuda.synchronize()
    with no_synchronising_call():
        for _ in range(3):
            sim.frame()
    assert sim.substeps_used == 20

    # ms per frame in turns: eager, graph, frame(), graph, eager.
    def loop(frame_fn, st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_TURN_FRAMES):
            st, _ = frame_fn(st)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / GRAPH_TURN_FRAMES * 1e3, st

    def sim_loop():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_TURN_FRAMES):
            sim.frame()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / GRAPH_TURN_FRAMES * 1e3

    def graph_frame(st):
        return fn(st, TIME_SCALE, FRAME_DT)

    eager_ms, graph_ms, sim_ms = [], [], []
    st = e_st
    for turn in ("eager", "graph", "sim", "graph", "eager"):
        if turn == "sim":
            sim_ms.append(sim_loop())
            continue
        ms, st = loop(eager if turn == "eager" else graph_frame, st)
        (eager_ms if turn == "eager" else graph_ms).append(ms)

    # One profiled window of three graph frames: the card's busy time.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            st, _ = graph_frame(st)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    idle = 1.0 - busy_ms / window_ms if events else None

    # The replay alone, and the copies around it, on the card's clock.
    graph = next(iter(fn.graphs.graphs.values()))
    values = scalar_values(frame_dynamics(cfg, TIME_SCALE, FRAME_DT, 20, cfg.effective_dt(),
                                          cfg.physics_dt), cfg)[0]
    copy_in_ms = device_ms(lambda: graph.copy_in(st, values), DEV, 5)
    replay_ms = device_ms(graph.graph.replay, DEV, 5)
    copy_out_ms = device_ms(lambda: graph.copy_out(st), DEV, 5)
    state_bytes = sum(getattr(st, f.name).nbytes for f in dataclasses.fields(st))
    return {"phase": "graphs", "case": name, "B": b, "P": cfg.max_particles, "substeps": 20,
            "replays_bitwise_eager": len(calls), "time_scales": sorted({c[0] for c in calls}),
            "frame_dts": sorted({c[1] for c in calls}), "fused_run_bitwise_eager": 2,
            "captures_frame_fn": fn.graphs.captures, "captures_run_fn": run.graphs.captures,
            "launches_per_frame": dict(zip(("force_step", "force_step_small", "overlap_step",
                                            "ejecta_decay_substep"), per_frame)),
            "synchronising_calls_in_a_replay": 0, "synchronising_calls_in_3_sim_frames": 0,
            "eager_ms_per_frame": eager_ms, "graph_ms_per_frame": graph_ms,
            "sim_frame_ms_per_frame": sim_ms,
            "fused_run_of_3_ms_per_frame_first_call_and_second": fused_ms,
            "first_call_s": first_call_s,
            "capture_s": list(capture_s), "profiled_window_ms": window_ms,
            "profiled_device_events": len(events), "profiled_busy_ms": busy_ms,
            "idle_share": idle, "replay_device_ms": replay_ms, "copy_in_ms": copy_in_ms,
            "copy_out_ms": copy_out_ms, "state_bytes": state_bytes,
            "pool_bytes_after_frame_capture": pool_after_frame,
            "pool_bytes_after_run_capture": pool_after_run, "card": smi}


def phase_graphs(smi: str) -> None:
    """The compiled frame buckets: for U-238 and He-4 at 10240 nuclei and
    one U-238 nucleus, on fresh factories, the first call (the eager frame
    and the capture), five replays against eager frames bitwise across a
    time scale of 1e7 years per second and a frame interval of 1/30 s with
    one capture, the launch counters equal to eager's, a replay and three
    ``Simulation.frame()`` calls with PyTorch's synchronisation check set
    to raise, ``make_run_fn(3)`` against three eager frames twice; then ms
    per frame in turns, the card's idle share over three profiled graph
    frames, the capture's seconds, the replay and copy times on the card's
    clock and the memory pool's bytes."""
    for name, zn, pad_to, b in GRAPH_CASES:
        with timed_captures() as capture_s:
            emit(_graph_case(name, zn, pad_to, b, capture_s, smi))
        torch.cuda.empty_cache()


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
    evolved = timed("12 rasterizer", phase_rasterizer, smi)
    timed("13 packed frames", phase_packed_frames, smi, evolved)
    timed("14 frame reader", phase_frame_reader, smi)
    view = timed("15 viewer", phase_viewer, smi)
    view_decay_launches = timed("16 live CLI and examples", phase_cli_live_and_examples, smi)
    sharded = timed("17 sharded path, world of one", phase_sharded, smi)
    timed("18 graphs", phase_graphs, smi)
    by_name = {k["name"]: k for k in kernels}
    by_name["force"]["sim_launches"] = u238["force_step"]
    by_name["overlap"]["sim_launches"] = u238["overlap_step"] + he4["overlap_step"]
    by_name["force_small"]["sim_launches"] = he4["force_step_small"]
    by_name["decay_stats"]["sim_launches"] = cli_decay_launches  # --survival, --populations
    by_name["substep"]["sim_launches"] = (u238["ejecta_decay_substep"]
                                          + he4["ejecta_decay_substep"])
    by_name["force"]["view_launches"] = view["force_step"]
    by_name["overlap"]["view_launches"] = view["overlap_step"]
    by_name["force_small"]["view_launches"] = view["force_step_small"]
    by_name["decay_stats"]["view_launches"] = view_decay_launches  # examples_torch/survival_curve.py
    by_name["substep"]["view_launches"] = view["ejecta_decay_substep"]
    for name, count in sharded.items():
        by_name[name]["sharded_launches"] = count
    assert all(k["launches"] > 0 and k["sim_launches"] > 0 and k["view_launches"] > 0
               and k["sharded_launches"] > 0 for k in kernels), kernels
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
