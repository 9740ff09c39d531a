"""Full-physics ensemble frames through ``Simulation.frame()``, the loop of
the command line's ``--ensemble`` mode, closed: each call is made as soon
as the previous one returns (``frame()`` itself keeps at most four frames
in flight). One ``status()`` ends the window, and a fence after it.

Workload keys: ``members``, ``geometry_seed`` (the initial positions are
this seed's, in an order drawn from the run's seed: see
:func:`with_geometry`), ``time_scale`` (a preset name), ``frame_dt``,
``warmup_frames`` (set-up runs this many frames: a count, not a time, so
that every run's window starts at the same frame of the ensemble's
evolution, along which a frame's cost moves by some percent),
``trace_frames`` (frames in the window of a traced run, after a lead-in of
:data:`LEAD_FRAMES` that fills the pipeline), ``sample_within`` (the
checked frame is drawn from the window's first so many) and ``limits``.

``correct``: the start (the program's initial ensemble against the
reference's ``ensemble_init`` from the same seeds, in the same order) and
two frames of the window (one drawn from the seed and the last), each
followed by the reference from the program's own state before it; the
window-end ``status()`` against the reference's totals of the last frame.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import compare
from benchmark.harness import Context, Result, log, quarters
from benchmark.traces import profiled

# Frames run under the profiler before a traced window opens: twice the
# four that Simulation.frame() keeps in flight, so that the window opens on
# a full pipeline.
LEAD_FRAMES = 8


def port_config(config: dict, mode: str):
    """The port's SimConfig that the configuration file states."""
    from pyqmd_tpu_torch.config import SimConfig

    fields = dict(config["sim_config"])
    if isinstance(fields.get("max_chain_log"), dict):
        fields["max_chain_log"] = fields["max_chain_log"][mode]
    return SimConfig(**fields)


def with_geometry(state, ensemble_init, cfg, w: dict, seed: int):
    """``state`` with the initial positions of ``ensemble_init``'s ensemble
    from the workload's ``geometry_seed``, in an order drawn from the run's
    ``seed``: every run starts from the same set of geometries, so that the
    seed changes their order and not the work. The members' own streams
    (decays, ejecta) stay the seed's."""
    import torch

    dev = state.pos.device
    order = torch.randperm(state.batch, generator=torch.Generator().manual_seed(seed))
    pos = ensemble_init(cfg, state.batch, seed=w["geometry_seed"], device=dev).pos
    return state.replace(pos=pos[order.to(dev)])


def as_reference_state(st):
    """The program's state tensors as the reference's state type (the
    reference reads them as its input or to judge them)."""
    from benchmark.reference.state import NucleusState

    return NucleusState(**{f: getattr(st, f) for f in NucleusState.__dataclass_fields__})


def check_frames(ctx: Context, kept: list, mode: str, raw_physics_dt: str = "config",
                 aggregates: bool = True) -> tuple[list, list]:
    """The numbers of each kept frame ``(before, after, metrics)``: the
    reference's frame from the program's state ``before`` against
    ``after`` and its metrics (with ``aggregates``, the ensemble totals
    too). Returns the numbers and the reference's metrics per frame."""
    from benchmark.reference import frame as ref

    rcfg = ref.config_from_file(ctx.config, mode)
    w = ctx.workload
    ts = ref.TIME_SCALE_PRESETS[w["time_scale"]]
    steps, eff = ref.schedule(rcfg, ts, w["frame_dt"])
    raw = rcfg.physics_dt if raw_physics_dt == "config" else None
    keys = compare.INT_METRICS + compare.FLOAT_METRICS
    if not aggregates:
        keys = tuple(k for k in keys if not k.startswith("total_"))
    out, refs = [], []
    for before, after, metrics in kept:
        new, new_m = ref.full_frame(as_reference_state(before), rcfg, ts, w["frame_dt"], steps,
                                    eff, raw)
        ks = [k for k in keys if k in metrics]
        out.append(compare.frame_numbers(after, new, {k: metrics[k] for k in ks},
                                         {k: new_m[k] for k in ks}))
        refs.append(new_m)
    return out, refs


def run(ctx: Context) -> Result:
    import torch
    from torch.profiler import record_function

    from pyqmd_tpu_torch import Simulation
    from pyqmd_tpu_torch.core.init import ensemble_init
    from pyqmd_tpu_torch.core.step import make_frame_fn

    w = ctx.workload
    dev = torch.device(ctx.device, 0) if ctx.device == "cuda" else torch.device(ctx.device)
    cuda = dev.type == "cuda"
    members = w["members"]
    sim = Simulation(port_config(ctx.config, "ensemble"), seed=ctx.seed, ensemble=members,
                     device=dev)
    sim.state = with_geometry(sim.state, ensemble_init, sim.cfg, w, ctx.seed)
    sim.set_preset(w["time_scale"])
    init = sim.state
    fdt = w["frame_dt"]
    for _ in range(w["warmup_frames"]):
        with record_function("bench.frame"):
            sim.frame(fdt)
    sim.status()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t_start

    limit = w["trace_frames"] if ctx.trace else w["sample_within"]
    sample = int(np.random.default_rng(ctx.seed).integers(0, limit))
    kept, loop = [], {"frames": 0, "before": None, "done": []}

    def window(deadline=None, frames=None):
        while (frames is not None and loop["frames"] < frames) or (
                deadline is not None and time.perf_counter() < deadline):
            before = sim.state
            with record_function("bench.frame"):
                sim.frame(fdt)
            if loop["frames"] == sample:
                kept.append((before, sim.state, sim.last_metrics))
            loop["before"] = before
            loop["frames"] += 1
            loop["done"].append(time.perf_counter())
        with record_function("bench.status"):
            loop["status"] = sim.status()
        if cuda:
            torch.cuda.synchronize(dev)

    def lead():
        for _ in range(LEAD_FRAMES):
            sim.frame(fdt)
        loop["start"] = sim.state

    t0 = time.perf_counter()
    traces = []
    if ctx.trace:
        traces.append(profiled(lambda: window(frames=w["trace_frames"]), dev, lead))
    else:
        window(deadline=t0 + ctx.seconds)
    elapsed = time.perf_counter() - t0
    frames = loop["frames"]
    steps = sim.substeps_used
    last = (loop["before"], sim.state, sim.last_metrics)
    if not kept or kept[0][0] is not last[0]:
        kept.append(last)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    nan_frames = sum(int(m["nan"].any()) for _, _, m in kept)
    log(f"sim_frames: {frames} frames of {members} members x {steps} substeps in "
        f"{elapsed:.6f} s; checked frames {sample} and {frames - 1}; frames/s by quarter "
        f"{quarters(loop['done'], t0, t0 + elapsed)}")

    if ctx.trace:
        from benchmark import roofline

        start, end = loop.pop("start"), sim.state
        traces[0].info.update(
            frames=frames, members=members, substeps=steps, slots=members * end.alive.shape[1],
            alive_pairs=(roofline.alive_pairs(start.alive) + roofline.alive_pairs(end.alive)) / 2,
            overlap_pairs_in_range=roofline.pairs_in_range(end.pos, end.alive,
                                                           sim.cfg.overlap_min_dist))
    status = loop["status"]
    del sim
    start = end = None
    make_frame_fn.cache_clear()  # the graphs and their pools
    if cuda:
        torch.cuda.empty_cache()

    numbers = compare.worst(check_frames(ctx, kept, "ensemble")[0])
    from benchmark.reference import frame as ref

    rcfg = ref.config_from_file(ctx.config, "ensemble")
    numbers.update(compare.init_numbers(init, with_geometry(
        ref.ensemble_init(rcfg, members, seed=ctx.seed, device=dev), ref.ensemble_init, rcfg, w,
        ctx.seed)))
    _, last_after, _ = kept[-1]
    numbers["status_differing"] = status_differing(status, last_after)
    return Result(attempted=frames, failed=nan_frames, setup_s=setup_s,
                  e2e={"full_nucleus_substeps_per_s": frames * members * steps / elapsed},
                  numbers=numbers, memory_peak_bytes=int(peak), traces=traces)


def status_differing(status: dict, after) -> int:
    """Entries of the batched ``status()`` (alive total, decay counts) that
    differ from the sums over the state it was read from, which the frame
    check holds to the reference."""
    alive = int(after.alive.sum())
    counts = after.decay_counts.sum(0).tolist()
    return int(status["alive"] != alive) + sum(int(a != b) for a, b in
                                               zip(status["decay_counts"], counts))
