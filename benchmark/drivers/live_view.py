"""One nucleus watched live: per iteration ``Simulation.frame()``, then the
800x600 packed picture (``render_frame_packed``) submitted to a
``PipelinedFrameReader`` of depth 3, and ``unpack_frame`` on the host for
the frame it hands back, closed-loop (no frame-rate sleep). A frame's
latency runs from the start of the ``frame()`` call that made it to its
unpacked pixels on the host; the reader is drained at the window's end.

Workload keys: ``time_scale``, ``frame_dt``, ``width``, ``height``,
``depth``, ``warmup_frames`` and ``warmup_seconds`` (as in
:mod:`.sim_frames`), ``trace_frames`` (after the same lead-in),
``sample_within`` and ``limits``.

``correct``: the start (the program's initial nucleus against the
reference's ``init_state``); for two frames (one drawn from the seed and
the last delivered) the pixels as they reached the host against the
reference's rasterizer on the program's state of that frame, with the same
camera and zoom, and the reference's frame from the program's state before
it.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from benchmark import compare
from benchmark.drivers.sim_frames import (
    LEAD_FRAMES,
    as_reference_state,
    check_frames,
    port_config,
)
from benchmark.harness import Context, Result, log, quarters
from benchmark.traces import profiled


def run(ctx: Context) -> Result:
    import torch
    from torch.profiler import record_function

    from pyqmd_tpu_torch import Simulation
    from pyqmd_tpu_torch.core.step import make_frame_fn
    from pyqmd_tpu_torch.render.interactive import (
        PipelinedFrameReader,
        render_frame_packed,
        unpack_frame,
    )

    w = ctx.workload
    dev = torch.device(ctx.device, 0) if ctx.device == "cuda" else torch.device(ctx.device)
    cuda = dev.type == "cuda"
    width, height, fdt = w["width"], w["height"], w["frame_dt"]
    sim = Simulation(port_config(ctx.config, "single"), seed=ctx.seed, device=dev)
    sim.set_preset(w["time_scale"])
    init = sim.state
    # The reader hands back a one-tuple, so that a frame whose pixels fall
    # outside its palette (unpacked to None) is seen, not skipped.
    reader = PipelinedFrameReader(depth=w["depth"], decode=lambda a: (unpack_frame(a),))
    pending: collections.deque = collections.deque()
    # A traced run's frames are counted from the lead-in's first.
    first, limit = (LEAD_FRAMES, w["trace_frames"]) if ctx.trace else (0, w["sample_within"])
    sample = first + int(np.random.default_rng(ctx.seed).integers(0, limit))
    loop = {"frames": 0, "latency": [], "kept": [], "dropped": 0, "last": None, "done": []}

    def deliver(frame) -> None:
        t_call, i, before, after, metrics, camera, zoom = pending.popleft()
        rgb = frame[0]
        now = time.perf_counter()
        loop["latency"].append(now - t_call)
        loop["done"].append(now)
        loop["dropped"] += int(rgb is None)
        record = (i, before, after, metrics, camera, zoom, rgb)
        if i == sample:
            loop["kept"].append(record)
        loop["last"] = record

    def step() -> None:
        t_call = time.perf_counter()
        before = sim.state
        with record_function("bench.frame"):
            sim.frame(fdt)
        camera, zoom = (float(sim.camera[0]), float(sim.camera[1])), float(sim.zoom)
        with record_function("bench.render"):
            packed = render_frame_packed(sim.state, camera, zoom, width, height)
        pending.append((t_call, loop["frames"], before, sim.state, sim.last_metrics, camera, zoom))
        loop["frames"] += 1
        with record_function("bench.readback"):
            out = reader.submit(packed)
            if out is not None:
                deliver(out)

    def drain() -> None:
        with record_function("bench.readback"):
            for out in reader.flush():
                deliver(out)
        if cuda:
            torch.cuda.synchronize(dev)

    t_warm = time.perf_counter()
    while loop["frames"] < w["warmup_frames"] or (
            time.perf_counter() - t_warm < w["warmup_seconds"]):
        step()
    drain()
    loop.update(frames=0, latency=[], kept=[], dropped=0, done=[])
    setup_s = time.perf_counter() - ctx.t_start

    def frames_until(deadline=None, frames=None):
        while (frames is not None and loop["frames"] < frames) or (
                deadline is not None and time.perf_counter() < deadline):
            step()

    t0 = time.perf_counter()
    traces = []
    if ctx.trace:
        traces.append(profiled(
            lambda: (frames_until(frames=LEAD_FRAMES + w["trace_frames"]), drain()), dev,
            lambda: frames_until(frames=LEAD_FRAMES)))
        traces[0].info.update(frames=w["trace_frames"])
    else:
        frames_until(deadline=t0 + ctx.seconds)
        drain()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    latency = np.asarray(loop["latency"])
    delivered = len(latency) - loop["dropped"]
    log(f"live_view: {loop['frames']} frames made, {delivered} delivered in {elapsed:.6f} s; "
        f"latency samples {len(latency)}, median {np.median(latency) * 1e3:.3f} ms, "
        f"p95 {np.percentile(latency, 95) * 1e3:.3f} ms; checked frames {sample} and "
        f"{loop['last'][0]}; frames/s by quarter {quarters(loop['done'], t0, t0 + elapsed)}")
    kept = loop["kept"]
    if not kept or kept[0][0] != loop["last"][0]:
        kept.append(loop["last"])
    del sim, reader, pending
    make_frame_fn.cache_clear()
    if cuda:
        torch.cuda.empty_cache()

    numbers = compare.worst(check_frames(ctx, [(b, a, m) for _, b, a, m, *_ in kept], "single")[0])
    numbers["pixels_differing_share"] = max(picture_gaps(kept, width, height))
    from benchmark.reference import frame as ref
    from benchmark.reference.init import init_state

    numbers.update(compare.init_numbers(init, init_state(
        ref.config_from_file(ctx.config, "single"), seed=ctx.seed, device=dev)))
    return Result(attempted=len(latency), failed=loop["dropped"], setup_s=setup_s,
                  e2e={"view_frames_per_s": delivered / elapsed,
                       "view_frame_ms_p95": float(np.percentile(latency, 95) * 1e3)},
                  numbers=numbers, memory_peak_bytes=int(peak), traces=traces)


def picture_gaps(kept: list, width: int, height: int) -> list[float]:
    """Share of pixels, per kept frame, in which the picture that reached
    the host differs from the reference's picture of the program's state."""
    from benchmark.reference import frame as ref

    out = []
    for _, _, after, _, camera, zoom, rgb in kept:
        want = ref.picture(as_reference_state(after), camera, zoom, width, height)
        out.append(compare.pixels_differing_share(rgb, want))
    return out
