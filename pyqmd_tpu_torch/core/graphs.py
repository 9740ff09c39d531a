"""CUDA graphs of the full-physics frame, one per bucket: the port's
counterpart of the JAX package's ``jax.jit`` frame and ``lax.scan`` run
(``pyqmd_tpu/core/step.py:511, 547``).

:class:`FrameGraphs` is the callable behind
:func:`~pyqmd_tpu_torch.core.step.make_frame_fn` and
:func:`~pyqmd_tpu_torch.core.step.make_run_fn`, and so behind the sharded
frames of :mod:`pyqmd_tpu_torch.parallel`; the ring and hybrid frames hold
their NCCL collectives inside the graph, as the JAX package's ``shard_map``
programs hold theirs (``pyqmd_tpu/parallel/ensemble.py:69``,
``ring.py:118``). On CPU tensors it runs the
frame eagerly. On the card a frame issues ~800 launches from the host,
and for a small batch the host's time, not the card's, sets its length; so
each graph bucket (batch size, device, whether ``raw_physics_dt`` is None,
and the ``time_scale > 1`` regime of the ejecta lifetime) is captured once
and replayed:

* The first call of a bucket runs its first frame eagerly on a side
  stream (the warm-up: its kernel wrappers build the kernel library and
  opt the kernels into their shared memory, it copies the constant tables
  to the device and runs every collective of the frame, so that NCCL has
  made its communicators, and the capture makes no such call) and returns
  that frame's result; then
  it captures the frame with :func:`torch.cuda.graph`. Its launches count
  as launches; the capture's do not.
* Later calls write the frame's scalars into the graph's scalar vector
  (:class:`~pyqmd_tpu_torch.core.dynamics.FrameScalars`) and the state into
  its static input, replay, and clone out the fields the frame writes: a
  returned state is fresh tensors that later replays do not touch. A new
  time scale, frame interval or physics dt replays without capturing
  again.
* A fused run of k frames replays its graph k times back to back (the
  graph copies its result back into its input) and computes the metrics
  once. It is no graph of k frames, whose instantiation time would grow
  with k.

A capture puts the kernels' counters of
:mod:`pyqmd_tpu_torch.utils.profiling` (the ``kernels.*`` names) back as
they were before it and keeps what its body launched; each replay counts
that again, so they still count launches on the card, and counts in
``graph.replays``; a capture counts in ``graph.captures``. The
host's parts of a call are the spans ``pyqmd.graph.warm_up``,
``capture``, ``copy_in``, ``replay`` and ``copy_out``, all outside the
captured body. A failed capture or replay raises and names the bucket;
nothing retries eagerly or on the CPU.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core.dynamics import (
    SCALAR_NAMES,
    FrameScalars,
    frame_dynamics,
    host_scalars,
    scalar_values,
    scalars_to_device,
)
from pyqmd_tpu_torch.state import NucleusState
from pyqmd_tpu_torch.utils.profiling import annotate, count, counters, restore_counters

FIELDS = tuple(f.name for f in dataclasses.fields(NucleusState))


class _Device:
    """What the graph buckets of one device share.

    One memory pool: replays of a device's buckets run one at a time, under
    ``lock``, in order on one stream (a replay on another stream first waits
    for the last one's), and each replay's outputs are cloned before the
    next replay is issued. So a bucket may reuse memory that another
    bucket's capture left to the pool: their replays never overlap, and no
    output is read after the next replay."""

    def __init__(self, device: torch.device):
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(device)
        self.lock = threading.Lock()
        self.stream = None  # the stream of the last replay


_DEVICES: dict = {}
_DEVICES_LOCK = threading.Lock()


def shared(device: torch.device) -> _Device:
    """The pool, side stream and lock of ``device``'s buckets."""
    with _DEVICES_LOCK:
        if device not in _DEVICES:
            _DEVICES[device] = _Device(device)
        return _DEVICES[device]


def _record(fn, dev: _Device) -> torch.cuda.CUDAGraph:
    """``fn()`` captured as a CUDA graph on ``dev``'s side stream and pool.

    The capture forbids unsafe CUDA calls on the capturing thread only
    (``thread_local``), for every bucket: in the default ``global`` mode a
    call from any other thread of the process during the capture (an NCCL
    process group's watchdog querying its events, a viewer's handler
    thread reading a frame) invalidates it."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=dev.pool, stream=dev.side,
                          capture_error_mode="thread_local"):
        fn()
    return graph


class Graph:
    """One captured bucket: its graph, its static scalar vector and state,
    the fields the frame writes, its metrics (and which of them are state
    fields), and what one replay counts: ``launches`` maps each kernel
    counter the captured body moved to how far it moved."""

    def __init__(self, graph, vec, static, written, metrics, alias, launches, name):
        self.graph = graph
        self.vec = vec
        self.static = static
        self.written = written
        self.metrics = metrics
        self.alias = alias
        self.launches = launches
        self.name = name

    def copy_in(self, state: NucleusState, values: np.ndarray) -> None:
        """The frame's scalars and every state field (the frame reads them
        all) into the static input, on the current stream."""
        self.vec.copy_(host_scalars(values, self.vec.device), non_blocking=True)
        for f in FIELDS:
            src, dst = getattr(state, f), self.static[f]
            if src.shape != dst.shape or src.dtype != dst.dtype or src.device != dst.device:
                raise ValueError(
                    f"{f} is {tuple(src.shape)} {src.dtype} on {src.device}; the frame graph "
                    f"of bucket {self.name} takes {tuple(dst.shape)} {dst.dtype} on {dst.device}")
            dst.copy_(src)

    def copy_out(self, state: NucleusState) -> tuple[NucleusState, dict | None]:
        """Fresh tensors of the fields the frame writes and of its metrics;
        the fields it passes through are the caller's own."""
        new = {f: self.static[f].clone() if f in self.written else getattr(state, f)
               for f in FIELDS}
        if self.metrics is None:
            return NucleusState(**new), None
        return NucleusState(**new), {
            k: new[self.alias[k]] if k in self.alias else v.clone()
            for k, v in self.metrics.items()
        }

    def replay(self, state: NucleusState, values: np.ndarray, frames: int):
        """``frames`` replays from ``state`` at the scalars ``values``."""
        try:
            with annotate("pyqmd.graph.copy_in"):
                self.copy_in(state, values)
            with annotate("pyqmd.graph.replay"):
                for _ in range(frames):
                    self.graph.replay()
                    for name, n in self.launches.items():
                        count(name, n)
                    count("graph.replays")
            with annotate("pyqmd.graph.copy_out"):
                return self.copy_out(state)
        except ValueError:
            raise
        except Exception as e:
            raise RuntimeError(f"replay of the frame graph of bucket {self.name} failed: {e}") from e


class FrameGraphs:
    """A frame function (``frames=1``) or fused run (``frames=k``) of one
    (config, substep-count) bucket: ``body(states, cfg, scalars,
    num_steps)`` is the frame without metrics and ``metrics(states)`` its
    metrics, which the graph holds where ``graph_metrics`` and a fused run
    computes once at the end.

    ``graphs`` maps each graph bucket to its :class:`Graph`; ``captures``
    counts the captures made. ``group`` names the process groups whose
    collectives the body runs (the particle-axis ring's), for the bucket's
    name; every rank of such a group must make its calls in lockstep, so
    that all of them capture at the same call."""

    def __init__(self, cfg: SimConfig, num_steps: int, body, metrics, frames: int,
                 graph_metrics: bool, group: str = ""):
        if frames < 0:
            raise ValueError(f"frames must be >= 0, got {frames}")
        self.cfg = cfg
        self.num_steps = num_steps
        self.body = body
        self.metrics = metrics
        self.frames = frames
        self.graph_metrics = graph_metrics
        self.group = group
        self.graphs: dict = {}
        self.captures = 0

    def bucket(self, state: NucleusState, raw_physics_dt, fast_lifetimes: bool) -> tuple:
        """The graph bucket of a call: the batch size, the device, whether
        ``raw_physics_dt`` is None and the lifetime regime."""
        return (state.batch, state.pos.device, raw_physics_dt is None, bool(fast_lifetimes))

    def describe(self, key: tuple) -> str:
        b, dev, raw_none, fast = key
        cfg = self.cfg
        group = f", {self.group}" if self.group else ""
        return (f"(Z={cfg.z}, N={cfg.n}, P={cfg.max_particles}, num_steps={self.num_steps}, "
                f"frames={self.frames}, B={b}, {dev}, raw_physics_dt "
                f"{'None' if raw_none else 'given'}, time_scale {'> 1' if fast else '<= 1'}"
                f"{group})")

    def __call__(self, state: NucleusState, time_scale, frame_dt, physics_dt, raw_physics_dt):
        dyn = frame_dynamics(self.cfg, time_scale, frame_dt, self.num_steps, physics_dt,
                             raw_physics_dt)
        values, fast = scalar_values(dyn, self.cfg)
        device = state.pos.device
        if device.type != "cuda" or self.frames == 0:
            sc = FrameScalars.views(scalars_to_device(values, device), fast)
            for _ in range(self.frames):
                state = self.body(state, self.cfg, sc, self.num_steps)
            return state, self.metrics(state)
        key = self.bucket(state, raw_physics_dt, fast)
        dev = shared(device)
        with dev.lock, torch.cuda.device(device):
            stream = torch.cuda.current_stream(device)
            if dev.stream is not None and dev.stream != stream:
                stream.wait_stream(dev.stream)
            dev.stream = stream
            metrics, frames = None, self.frames
            graph = self.graphs.get(key)
            if graph is None:
                state = self._warm_up(state, values, fast, dev)
                graph = self.graphs[key] = self._capture(state, fast, key, dev)
                frames -= 1
            if frames:
                state, metrics = graph.replay(state, values, frames)
            return state, metrics if metrics is not None else self.metrics(state)

    def _warm_up(self, state: NucleusState, values: np.ndarray, fast: bool,
                 dev: _Device) -> NucleusState:
        """The call's first frame, eagerly, on the side stream."""
        with annotate("pyqmd.graph.warm_up"):
            current = torch.cuda.current_stream()
            dev.side.wait_stream(current)
            with torch.cuda.stream(dev.side):
                sc = FrameScalars.views(scalars_to_device(values, state.pos.device), fast)
                out = self.body(state, self.cfg, sc, self.num_steps)
            current.wait_stream(dev.side)
            for f in FIELDS:
                getattr(state, f).record_stream(dev.side)
                getattr(out, f).record_stream(current)
            return out

    def _capture(self, template: NucleusState, fast: bool, key: tuple, dev) -> Graph:
        """Capture the frame (and its metrics where the graph holds them)
        on static tensors shaped as ``template``; the graph ends by copying
        the fields the frame writes back into its input."""
        name = self.describe(key)
        static = {f: torch.empty_like(getattr(template, f)) for f in FIELDS}
        vec = torch.empty(len(SCALAR_NAMES), dtype=torch.float32, device=template.pos.device)
        held = {}

        def frame():
            out = self.body(NucleusState(**static), self.cfg, FrameScalars.views(vec, fast),
                            self.num_steps)
            held["metrics"] = self.metrics(out) if self.graph_metrics else None
            held["out"] = out
            held["written"] = tuple(f for f in FIELDS if getattr(out, f) is not static[f])
            inputs = {t.untyped_storage().data_ptr() for t in static.values()}
            for f in held["written"]:
                if getattr(out, f).untyped_storage().data_ptr() in inputs:
                    raise ValueError(f"the frame's {f} is a view of its input")
                static[f].copy_(getattr(out, f))

        # Only the kernels' counters: another thread's count during the
        # capture (a sync, a drain) is its own, never a replay's.
        before = {k: v for k, v in counters().items() if k.startswith("kernels.")}
        try:
            with annotate("pyqmd.graph.capture"):
                graph = _record(frame, dev)
        except Exception as e:
            raise RuntimeError(f"capture of the frame graph of bucket {name} failed: {e}") from e
        finally:
            now = counters()
            launches = {k: now[k] - v for k, v in before.items() if now[k] != v}
            restore_counters(before)
        self.captures += 1
        count("graph.captures")
        out, metrics = held["out"], held["metrics"]
        alias = {}
        for k, v in (metrics or {}).items():
            for f in FIELDS:
                if v is getattr(out, f):
                    alias[k] = f
        return Graph(graph, vec, static, held["written"], metrics, alias, launches, name)
