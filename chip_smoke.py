#!/usr/bin/env python3
"""Run each main path of the PyTorch port once on one CUDA card, count the
kernels it launches, and hold each of those kernels to its plain PyTorch
version at that path's shapes.

    python3 chip_smoke.py

For every path the counters of :mod:`pyqmd_tpu_torch.utils.profiling` are
zeroed just before it runs through its own entry point; its kernel
launches are then read and checked, and every kernel it launched is run
again on the path's own state beside its plain version (the plain force
and overlap over the whole batch, a chunk at a time):

1. ``Simulation.frame()`` on 10,240 U-238 nuclei at the ``billion`` preset
   (the frame graphs; the tiled force kernel, overlap, the substep kernel);
2. the same on 10,240 He-4 nuclei (the sub-warp force kernel, no decay);
3. ``analysis.survival_curve`` of 2,097,152 C-14 nuclei, 20 frames of 10
   substeps: one decay-frame launch a frame, the fit within 1%; the frame
   kernel against the plain frame (key tree, a plain substep each) on the
   path's next frame, next rng included;
4. ``analysis.chain_populations`` of 65,536 U-238 nuclei, 30 frames: every
   member's alive and proton counts agree with its decay counts, and the
   frame kernel against the plain frame where the 8-slot chain ring wraps;
5. the live view of one U-238 nucleus: ``Simulation.frame()``, the
   800x600 packed picture and a frame reader of depth 3;
6. the sharded path in a world of one (NCCL rank 0 of 1):
   ``make_sharded_frame_fn`` on the U-238 ensemble of path 1 and
   ``make_sharded_decay_fn`` on the C-14 ensemble of path 3.

Kernel against plain: the force kernels within 5e-3 (the paths run fast
math), overlap within 1e-4, both bitwise on a second launch and leaving
dead slots as they were; the substep kernel over two substeps, integers,
clock and decay floats and velocities bitwise, fragment positions within
1e-4; the decay frame's integers, bitfields and next rng bitwise, its
floats within 1e-6 relative.

Times are not taken here: ``benchmark/run.py`` times every cell. Each
path prints a JSON line; the line before the last is the ``kernels``
summary (for each kernel its source, its launches on every path and its
largest difference from the plain version), the last
``{"ok": true, "device": {...}}``. Any failed check raises and exits
nonzero; without a CUDA device it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from pyqmd_tpu_torch import SimConfig, Simulation, analysis, ensemble_init, prng
from pyqmd_tpu_torch.core import decay as plain_decay
from pyqmd_tpu_torch.core import forces as plain_forces
from pyqmd_tpu_torch.core import overlap as plain_overlap
from pyqmd_tpu_torch.core import step
from pyqmd_tpu_torch.core.dynamics import frame_dynamics, frame_scalars
from pyqmd_tpu_torch.kernels.decay import DECAY_FIELDS, decay_stats_frame
from pyqmd_tpu_torch.kernels.forces import SMALL_MAX_PARTICLES, force_step
from pyqmd_tpu_torch.kernels.overlap import overlap_step
from pyqmd_tpu_torch.kernels.substep import SUBSTEP_FIELDS, ejecta_decay_substep
from pyqmd_tpu_torch.parallel import make_mesh, make_sharded_decay_fn, make_sharded_frame_fn
from pyqmd_tpu_torch.parallel import shard_ensemble
from pyqmd_tpu_torch.render import PipelinedFrameReader, render_frame_packed, unpack_frame
from pyqmd_tpu_torch.state import DECAY_ALPHA, DECAY_BETA_MINUS, DECAY_BETA_PLUS, PROTON
from pyqmd_tpu_torch.state import DECAY_NEUTRON_EMISSION, DECAY_PROTON_EMISSION
from pyqmd_tpu_torch.utils.profiling import counters, restore_counters

DEV = torch.device("cuda:0")
DT = 1 / 240.0
EXACT_TOL = 1e-4  # tests/test_kernel.py:43
FAST_ATOL = 5e-3  # tests/test_kernel.py:165
STATS_REL_TOL = 1e-6
SLICE_B = 10240
C14_B = 2_097_152  # the README's 2M-nucleus C-14 statistics
U238_CHAIN_B = 65_536
PLAIN_CHUNK = 1024  # nuclei a plain force or overlap call takes at P=256
TIME_SCALE = 3.15576e16  # 1e9 years per wall-second, the ``billion`` preset
FRAME_DT = 1 / 60
FRAMES = 3
VIEW_FRAMES = 8
INT_FIELDS = ("z", "n", "decay_counts", "chain_z0", "chain_n0", "chain_dtype",
              "chain_z1", "chain_n1", "chain_cursor", "rng", "alive", "ptype",
              "ej_type", "ej_alive", "ej_cursor")
STATS_FLOATS = ("half_life", "last_decay_time", "chain_time")

# Each kernel: its source, what it replaces, the counter that reads it.
KERNELS = {
    "force": ("csrc/forces.cu", "pyqmd_tpu/kernels/forces_pallas.py:236"),
    "force_small": ("csrc/forces_small.cu", "pyqmd_tpu/kernels/forces_pallas.py:117"),
    "overlap": ("csrc/overlap.cu", "pyqmd_tpu/kernels/overlap_pallas.py:38"),
    "substep": ("csrc/substep.cu", "none"),
    "decay_stats": ("csrc/decay.cu", "pyqmd_tpu/kernels/decay_pallas.py:78"),
}
SUMMARY = {name: {"name": name, "source": f"pyqmd_tpu_torch/{src}", "replaces": rep,
                  "launches": {}, "max_abs_err": 0.0}
           for name, (src, rep) in KERNELS.items()}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def zero_counters() -> None:
    restore_counters(dict.fromkeys(counters(), 0))


def launches() -> dict:
    c = counters()
    small = c["kernels.force_step.small_launches"]
    return {"force": c["kernels.force_step.launches"] - small, "force_small": small,
            "overlap": c["kernels.overlap_step.launches"],
            "substep": c["kernels.ejecta_decay_substep.launches"],
            "decay_stats": c["kernels.decay_stats_frame.launches"]}


def path_launches(path: str, want: dict) -> dict:
    """The launches since the counters were zeroed, each equal to
    ``want`` (a kernel not named there launched nothing)."""
    got = launches()
    assert got == {k: want.get(k, 0) for k in got}, (path, got, want)
    for name, n in got.items():
        if n:
            SUMMARY[name]["launches"][path] = n
    return got


def held(name: str, err: float, tol: float, what: str) -> None:
    assert err <= tol, (name, what, err, tol)
    SUMMARY[name]["max_abs_err"] = max(SUMMARY[name]["max_abs_err"], err)


def max_diff(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def check_force(states, cfg, what: str) -> None:
    """The force kernel the capacity routes to, on the whole batch, against
    the plain step a chunk at a time; a second launch bitwise equal."""
    pos, vel, ptype, alive = states.pos, states.vel, states.ptype, states.alive
    before = launches()
    kp, kv = force_step(pos, vel, ptype, alive, DT, cfg)
    name = "force_small" if launches()["force_small"] > before["force_small"] else "force"
    again = force_step(pos, vel, ptype, alive, DT, cfg)
    assert torch.equal(again[0], kp) and torch.equal(again[1], kv), (what, "relaunch")
    dead = ~alive
    assert torch.equal(kp[dead], pos[dead]) and torch.equal(kv[dead], vel[dead]), what
    err = 0.0
    for s in range(0, states.batch, PLAIN_CHUNK):
        c = slice(s, s + PLAIN_CHUNK)
        rp, rv = plain_forces.force_step(pos[c], vel[c], ptype[c], alive[c], DT, cfg)
        err = max(err, max_diff(kp[c], rp), max_diff(kv[c], rv))
    held(name, err, FAST_ATOL if cfg.fast_math else EXACT_TOL, what)
    emit({"check": name, "path": what, "B": states.batch, "P": cfg.max_particles,
          "max_abs_diff": err, "relaunch_bitwise": True})


def check_overlap(states, cfg, what: str) -> None:
    pos, alive = states.pos, states.alive
    u = torch.rand(pos.shape[:2], device=DEV, generator=torch.Generator(DEV).manual_seed(0)) * 6.0
    got = overlap_step(pos, alive, u, cfg)
    assert torch.equal(overlap_step(pos, alive, u, cfg), got), (what, "relaunch")
    assert torch.equal(got[~alive], pos[~alive]), what
    err = 0.0
    for s in range(0, states.batch, PLAIN_CHUNK):
        c = slice(s, s + PLAIN_CHUNK)
        err = max(err, max_diff(got[c], plain_overlap.resolve_overlaps(pos[c], alive[c], u[c],
                                                                       cfg)))
    held("overlap", err, EXACT_TOL, what)
    emit({"check": "overlap", "path": what, "B": states.batch, "P": cfg.max_particles,
          "max_abs_diff": err, "relaunch_bitwise": True})


def check_substep(states, cfg, time_scale: float, steps: int, what: str) -> None:
    """Two substeps in place on a copy of the path's state, each against
    the plain ``advance_ejecta`` + ``maybe_decay`` on the card from the same
    state and key: integers, the clock's and the decay engine's floats and
    every velocity bitwise, ``ej_pos`` within EXACT_TOL (a fragment sits at
    a centre of mass summed in another order)."""
    sc = frame_scalars(frame_dynamics(cfg, time_scale, FRAME_DT, steps, None, cfg.physics_dt),
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
            assert torch.equal(getattr(got, f), getattr(want, f)), (what, s, f)
        err = max(err, max_diff(got.ej_pos, want.ej_pos))
        fired += int((want.chain_cursor != prev.chain_cursor).sum())
    held("substep", err, EXACT_TOL, what)
    emit({"check": "substep", "path": what, "B": states.batch, "substeps": 2,
          "decays_compared": fired, "max_abs_diff": err})


def rel_err(a, b) -> float:
    """Largest relative difference of two float arrays, inf == inf."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    rel[same] = 0.0
    return float(rel.max(initial=0.0))


def check_decay_frame(states, cfg, sim_dt: float, what: str) -> dict:
    """The frame kernel against the plain frame (the frame's key tree, then
    a plain substep per key) on the path's own next frame of 10 substeps:
    integers, bitfields and next rng bitwise, floats within STATS_REL_TOL."""
    adv, dyn = step._frame_clock(states, cfg, sim_dt, 1.0, 10, cfg.effective_dt(),
                                 cfg.physics_dt)
    bits = plain_decay.pack_nucleon_bits(adv.alive, adv.ptype)
    k3 = prng.split(adv.rng, 3)
    want, want_bits = adv, bits
    for keys in prng.split(k3[:, 0], 10).transpose(0, 1):
        want, _, want_bits = plain_decay.maybe_decay(want, cfg, keys.contiguous(), dyn,
                                                     stats_only=True, packed_nucleons=want_bits)
    got = adv.replace(**{f: getattr(adv, f).clone() for f in DECAY_FIELDS})
    got_bits = tuple(x.clone() for x in bits)
    next_rng = decay_stats_frame(got, got_bits, adv.rng, cfg, dyn, 10)
    assert torch.equal(next_rng, k3[:, 2]), (what, "next rng")
    for f in DECAY_FIELDS:
        if f not in STATS_FLOATS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (what, f)
    for i, (a, b) in enumerate(zip(got_bits, want_bits)):
        assert torch.equal(a, b), (what, f"bitfield {i}")
    rel = max(rel_err(getattr(got, f).cpu().numpy(), getattr(want, f).cpu().numpy())
              for f in STATS_FLOATS)
    assert rel <= STATS_REL_TOL, (what, rel)
    SUMMARY["decay_stats"]["max_abs_err"] = max(SUMMARY["decay_stats"]["max_abs_err"], rel)
    fired = got.chain_cursor - adv.chain_cursor
    out = {"check": "decay_stats", "path": what, "B": adv.batch, "C": cfg.max_chain_log,
           "substeps": 10, "decays": int(fired.sum()),
           "ring_wrap_members": int(((fired > 0) & (got.chain_cursor > cfg.max_chain_log)).sum()),
           "next_rng_bitwise": True, "max_rel_diff": rel}
    emit(out)
    return out


def path_frames(isotope: str, z: int, n: int, pad_to: int) -> None:
    """Paths 1 and 2: ``Simulation.frame()`` on an ensemble; its first call
    runs the eager frame and captures the bucket's graph, the rest replay."""
    sim = Simulation(z=z, n=n, ensemble=SLICE_B, pad_to=pad_to, seed=0, device=DEV)
    sim.set_preset("billion")
    cfg = sim.cfg
    path = f"{isotope}.frames"
    zero_counters()
    for _ in range(FRAMES):
        sim.frame()
    torch.cuda.synchronize()
    steps = sim.substeps_used
    force = "force_small" if cfg.max_particles <= SMALL_MAX_PARTICLES else "force"
    got = path_launches(path, {force: FRAMES * steps, "substep": FRAMES * steps,
                               "overlap": FRAMES * cfg.overlap_iterations})
    m = sim.last_metrics
    assert not bool(m["nan"].any()), path
    decays = int(m["total_decay_counts"].sum())
    assert decays > 0 if z > 2 else decays == 0, (path, decays)
    emit({"path": path, "B": SLICE_B, "P": cfg.max_particles, "frames": FRAMES,
          "substeps_per_frame": steps, "launches": got, "decays": decays})
    check_force(sim.state, cfg, path)
    check_overlap(sim.state, cfg, path)
    check_substep(sim.state, cfg, sim.time_scale, steps, path)


def path_survival() -> None:
    path = "c14.survival"
    zero_counters()
    res = analysis.survival_curve(6, 8, batch=C14_B, frames=20, half_lives=2.0, substeps=10,
                                  seed=0, device=DEV)
    got = path_launches(path, {"decay_stats": 20})
    assert res.rel_error < 0.01, res.rel_error
    assert np.all(np.diff(res.survival) <= 0) and res.survival.shape == (21,)
    emit({"path": path, "B": C14_B, "frames": 20, "launches": got,
          "rel_error": res.rel_error})
    # The same run through its frame loop, to hold the path's own state.
    _, cfg, st, fn, sim_dt = analysis._ensemble_setup(6, 8, C14_B, 20, 2.0, 10, 0, 8, True, 8,
                                                      None, DEV)
    for _ in range(20):
        st, _ = fn(st, sim_dt, 1.0)
    assert check_decay_frame(st, cfg, sim_dt, path)["decays"] > C14_B // 200


def path_chain() -> None:
    path = "u238.chain_populations"
    zero_counters()
    out = analysis.chain_populations(92, 146, batch=U238_CHAIN_B, frames=30, half_lives=3.0,
                                     device=DEV)
    got = path_launches(path, {"decay_stats": 30})
    # The same run once more through its frame loop, to hold its final state;
    # its populations must be the entry point's.
    _, cfg, final, fn, sim_dt = analysis._ensemble_setup(92, 146, U238_CHAIN_B, 30, 3.0, 10, 0,
                                                         8, True, 8, None, DEV)
    for _ in range(30):
        final, _ = fn(final, sim_dt, 1.0)
    zn, cnt = np.unique(torch.stack([final.z, final.n], 1).cpu().numpy(), axis=0,
                        return_counts=True)
    assert {f"{z}:{n}": int(c) for (z, n), c in zip(zn, cnt)} == {
        k: v[-1] for k, v in out["populations"].items() if v[-1]}
    counts = final.decay_counts.long()
    n_alive = final.alive.sum(-1)
    n_prot = (final.alive & (final.ptype == PROTON)).sum(-1)
    alpha = counts[:, DECAY_ALPHA]
    emitted_n, emitted_p = counts[:, DECAY_NEUTRON_EMISSION], counts[:, DECAY_PROTON_EMISSION]
    bad_a = int((n_alive != 238 - 4 * alpha - emitted_n - emitted_p).sum())
    bad_p = int((n_prot != 92 - 2 * alpha - emitted_p + counts[:, DECAY_BETA_MINUS]
                 - counts[:, DECAY_BETA_PLUS]).sum())
    assert bad_a == 0 and bad_p == 0, (bad_a, bad_p)
    emit({"path": path, "B": U238_CHAIN_B, "frames": 30, "launches": got,
          "total_alpha": int(alpha.sum()), "members_checked": U238_CHAIN_B})
    # Past Pb-214 the members have filled the 8-slot ring and write over it.
    assert check_decay_frame(final, cfg, sim_dt, path)["ring_wrap_members"] > 0


def path_view() -> None:
    """The live view of one nucleus, as the benchmark's view cell drives it."""
    path = "u238.view"
    sim = Simulation(z=92, n=146, pad_to=128, seed=0, device=DEV)
    sim.set_preset("billion")
    # A one-tuple, so that a frame unpacked to None (a pixel outside the
    # palette) is handed back, not skipped.
    reader = PipelinedFrameReader(depth=3, decode=lambda a: (unpack_frame(a),))
    zero_counters()
    shown = []
    for _ in range(VIEW_FRAMES):
        sim.frame()
        out = reader.submit(render_frame_packed(sim.state, (float(sim.camera[0]),
                                                            float(sim.camera[1])),
                                                float(sim.zoom), 800, 600))
        if out is not None:
            shown.append(out)
    shown += reader.flush()
    steps = sim.substeps_used
    got = path_launches(path, {"force": VIEW_FRAMES * steps, "substep": VIEW_FRAMES * steps,
                               "overlap": VIEW_FRAMES * sim.cfg.overlap_iterations})
    assert len(shown) == VIEW_FRAMES, len(shown)
    assert all(f[0] is None or f[0].shape == (600, 800, 3) for f in shown)
    emit({"path": path, "B": 1, "P": sim.cfg.max_particles, "frames": VIEW_FRAMES,
          "launches": got})
    check_force(sim.state, sim.cfg, path)
    check_overlap(sim.state, sim.cfg, path)
    check_substep(sim.state, sim.cfg, sim.time_scale, steps, path)


def path_sharded() -> None:
    mesh = make_mesh()
    assert (dist.get_world_size(), dist.get_backend()) == (1, "nccl")
    try:
        path = "u238.sharded_frames"
        cfg = SimConfig.for_isotope(92, 146, pad_to=128)
        steps = cfg.num_substeps(FRAME_DT, TIME_SCALE)
        st = shard_ensemble(ensemble_init(cfg, SLICE_B, seed=0, device=DEV), mesh)
        frame = make_sharded_frame_fn(cfg, steps, mesh)
        zero_counters()
        for _ in range(FRAMES):
            st, m = frame(st, TIME_SCALE, FRAME_DT)
        torch.cuda.synchronize()
        got = path_launches(path, {"force": FRAMES * steps, "substep": FRAMES * steps,
                                   "overlap": FRAMES * cfg.overlap_iterations})
        assert int(m["survivors"]) == int(((st.z == 92) & (st.n == 146)).sum())
        emit({"path": path, "world": 1, "backend": "nccl", "B": SLICE_B, "launches": got})
        check_force(st, cfg, path)
        check_overlap(st, cfg, path)
        check_substep(st, cfg, TIME_SCALE, steps, path)

        path = "c14.sharded_decay"
        _, cfg, st, _, sim_dt = analysis._ensemble_setup(6, 8, C14_B, 20, 2.0, 10, 0, 8, True,
                                                         8, None, DEV)
        st = shard_ensemble(st, mesh)
        fn = make_sharded_decay_fn(cfg, 10, mesh)
        zero_counters()
        for _ in range(20):
            st, m = fn(st, sim_dt, 1.0)
        got = path_launches(path, {"decay_stats": 20})
        emit({"path": path, "world": 1, "backend": "nccl", "B": C14_B, "launches": got})
        check_decay_frame(st, cfg, sim_dt, path)
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    path_frames("u238", 92, 146, 128)
    path_frames("he4", 2, 2, 8)
    path_survival()
    path_chain()
    path_view()
    path_sharded()
    kernels = list(SUMMARY.values())
    assert all(k["launches"] for k in kernels), kernels
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
