"""An ensemble sharded over the cards of one host: one process per card
(NCCL over ``tcp://127.0.0.1``), ``make_mesh`` over the ``data`` axis,
every rank building the global ensemble and keeping its rows
(``shard_ensemble``), then ``make_sharded_frame_fn`` (the rank's frame
graph replayed, then one ``all_reduce`` of the aggregates) in a closed
loop, at most four frames in flight per rank. This process is rank 0 and
prints the result; the other ranks are spawned, as
``examples_torch/sharded_survival.py`` spawns them.

The window is rank 0's: before each frame rank 0 tells every rank, over a
gloo group on the host, whether its deadline has passed, so that all ranks
run the same frames in lockstep without waiting for their cards.

Workload keys: ``members`` (the global batch), ``geometry_seed``,
``time_scale``, ``frame_dt``, ``warmup_frames`` (as in
:mod:`.sim_frames`), ``trace_frames`` (after the same lead-in),
``sample_within`` and ``limits``.

``correct``: on every rank the start (its rows of the reference's global
``ensemble_init``, with the same geometries in the same order) and two
frames (one drawn from the seed, the last), each the reference's frame
from the program's own state before it; the all-reduced aggregates of
those frames against the sums of the reference's per-rank totals.
"""

from __future__ import annotations

import socket
import time
import traceback

import numpy as np

from benchmark import compare
from benchmark.drivers.sim_frames import LEAD_FRAMES, check_frames, port_config, with_geometry
from benchmark.harness import Context, Result, forbidden_loaded, log
from benchmark.traces import profiled

DEPTH = 4  # frames in flight per rank, as Simulation.frame() keeps
JOIN_SECONDS = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(ctx: Context, patch: str | None = None) -> Result:
    """Spawn ranks 1..chips-1, run rank 0 here, gather the results.
    ``patch`` ("module:function") is called first in every rank: a test's
    way to break the timed path underneath."""
    import multiprocessing as mp

    world, port = ctx.chips, _free_port()
    spawn = mp.get_context("spawn")
    queue = spawn.SimpleQueue()
    procs = [spawn.Process(target=_child, args=(r, world, port, ctx, queue, patch))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        own = rank_run(0, world, port, ctx, patch)
        others = [queue.get() for _ in procs]
    finally:
        for p in procs:
            p.join(JOIN_SECONDS)
            if p.is_alive():
                p.terminate()
                p.join()
    for o in others:
        if "error" in o:
            raise RuntimeError(f"rank {o['rank']} failed:\n{o['error']}")
        if o["forbidden"]:
            raise RuntimeError(f"rank {o['rank']} loaded {o['forbidden']}")
    result = own["result"]
    result.memory_peak_bytes = max([result.memory_peak_bytes] + [o["peak"] for o in others])
    result.traces += [o["trace"] for o in others if o["trace"] is not None]
    return result


def _child(rank, world, port, ctx, queue, patch) -> None:
    try:
        out = rank_run(rank, world, port, ctx, patch)
        queue.put({"rank": rank, "peak": out["result"].memory_peak_bytes,
                   "trace": out["result"].traces[0] if out["result"].traces else None,
                   "forbidden": forbidden_loaded()})
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def _call(path: str) -> None:
    import importlib

    module, fn = path.split(":")
    getattr(importlib.import_module(module), fn)()


def rank_run(rank: int, world: int, port: int, ctx: Context, patch: str | None) -> dict:
    """One rank: join the world, run the cell's part, leave the world."""
    import torch
    import torch.distributed as dist

    if patch:
        _call(patch)
    cuda = ctx.device == "cuda"
    kw = {}
    if cuda:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    else:
        dev = torch.device(ctx.device)
        torch.set_num_threads(2)  # ranks share the host's cores
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world, **kw)
    try:
        return _rank_body(rank, world, ctx, dev, dist.new_group(backend="gloo"))
    finally:
        dist.destroy_process_group()


def _rank_body(rank: int, world: int, ctx: Context, dev, ctl) -> dict:
    """The rank's set-up, window and check; ``ctl`` is a gloo group on the
    host for the window's lockstep and the check's exchange."""
    import torch
    import torch.distributed as dist
    from torch.profiler import record_function

    from benchmark.reference import frame as ref
    from pyqmd_tpu_torch.core.init import ensemble_init
    from pyqmd_tpu_torch.core.step import make_frame_fn
    from pyqmd_tpu_torch.parallel import make_mesh, make_sharded_frame_fn, shard_ensemble

    w = ctx.workload
    cuda = dev.type == "cuda"
    cfg = port_config(ctx.config, "ensemble")
    mesh = make_mesh((world,), ("data",), device=ctx.device)
    whole = with_geometry(ensemble_init(cfg, w["members"], seed=ctx.seed, device=dev),
                          ensemble_init, cfg, w, ctx.seed)
    st = shard_ensemble(whole, mesh)
    del whole
    init = st
    local = st.batch
    rcfg = ref.config_from_file(ctx.config, "ensemble")
    ts = ref.TIME_SCALE_PRESETS[w["time_scale"]]
    steps, _ = ref.schedule(rcfg, ts, w["frame_dt"])
    fn = make_sharded_frame_fn(cfg, steps, mesh)
    flag = torch.zeros(1, dtype=torch.int32)
    events: list = []

    def frame(state):
        with record_function("bench.sharded_frame"):
            state, metrics = fn(state, ts, w["frame_dt"])
        if cuda:
            events.append(torch.cuda.Event())
            events[-1].record()
            if len(events) > DEPTH:
                events.pop(0).synchronize()
        return state, metrics

    for _ in range(w["warmup_frames"]):
        st, _ = frame(st)
    if cuda:
        torch.cuda.synchronize(dev)
    dist.barrier(group=ctl)
    setup_s = time.perf_counter() - ctx.t_start

    limit = w["trace_frames"] if ctx.trace else w["sample_within"]
    sample = int(np.random.default_rng(ctx.seed).integers(0, limit))
    loop = {"frames": 0, "kept": [], "last": None}

    def window(deadline=None, frames=None):
        nonlocal st
        while True:
            if frames is not None:
                stop = loop["frames"] >= frames
            else:
                flag[0] = int(rank == 0 and time.perf_counter() >= deadline)
                dist.broadcast(flag, src=0, group=ctl)
                stop = bool(flag[0])
            if stop:
                break
            before = st
            st, metrics = frame(st)
            record = (before, st, metrics)
            if loop["frames"] == sample:
                loop["kept"].append(record)
            loop["last"] = record
            loop["frames"] += 1
        if cuda:
            torch.cuda.synchronize(dev)

    start = None

    def lead():
        nonlocal st, start
        for _ in range(LEAD_FRAMES):
            st, _ = frame(st)
        start = st

    dist.barrier(group=ctl)
    t0 = time.perf_counter()
    traces = []
    if ctx.trace:
        traces.append(profiled(lambda: window(frames=w["trace_frames"]), dev, lead))
    else:
        window(deadline=t0 + ctx.seconds)
    elapsed = time.perf_counter() - t0
    frames = loop["frames"]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if ctx.trace:
        from benchmark import roofline

        traces[0].info.update(
            frames=frames, members=local, substeps=steps, slots=local * st.alive.shape[1],
            alive_pairs=(roofline.alive_pairs(start.alive) + roofline.alive_pairs(st.alive)) / 2,
            overlap_pairs_in_range=roofline.pairs_in_range(st.pos, st.alive,
                                                           cfg.overlap_min_dist))
        start = None
    kept = loop["kept"]
    if not kept or kept[0][0] is not loop["last"][0]:
        kept.append(loop["last"])
    del fn, st, loop
    make_frame_fn.cache_clear()
    if cuda:
        torch.cuda.empty_cache()

    nums, refs = check_frames(ctx, kept, "ensemble", raw_physics_dt=None, aggregates=False)
    numbers = compare.worst(nums)
    rows = slice(rank * local, (rank + 1) * local)
    whole = with_geometry(ref.ensemble_init(rcfg, w["members"], seed=ctx.seed, device=dev),
                          ref.ensemble_init, rcfg, w, ctx.seed)
    numbers.update(compare.init_numbers(init, ref.rows(whole, rows)))

    # The reference's per-rank totals of each kept frame, summed over ranks.
    mine = [_totals(m, rcfg) for m in refs]
    gathered = [None] * world
    dist.all_gather_object(gathered, (mine, numbers, peak), group=ctl)
    numbers = compare.worst([g[1] for g in gathered])
    sums = [np.sum([g[0][i] for g in gathered], axis=0) for i in range(len(kept))]
    got = [np.concatenate([m["total_decay_counts"].cpu().numpy().ravel(),
                           [int(m["total_alive"]), int(m["survivors"])]]) for _, _, m in kept]
    numbers["aggregates_differing"] = int(sum((a != b).sum() for a, b in zip(got, sums)))
    if rank == 0:
        log(f"sharded_frames: {frames} frames of {world} x {local} members x {steps} substeps "
            f"in {elapsed:.6f} s; checked frames {sample} and {frames - 1}")
    result = Result(
        attempted=frames, failed=sum(int(m["nan"].any()) for _, _, m in kept), setup_s=setup_s,
        e2e={"full_nucleus_substeps_per_s": frames * world * local * steps / elapsed},
        numbers=numbers, memory_peak_bytes=int(peak), traces=traces)
    return {"result": result}


def _totals(m: dict, rcfg) -> np.ndarray:
    """A frame's decay totals by type, alive nucleons and survivors (members
    still in the initial isotope) over one rank's rows."""
    survivors = int(((m["z"] == rcfg.z) & (m["n"] == rcfg.n)).sum())
    return np.concatenate([m["total_decay_counts"].cpu().numpy().ravel(),
                           [int(m["total_alive"]), survivors]]).astype(np.int64)
